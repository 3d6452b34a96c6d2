"""``python -m enerf_tpu_torch.train`` on the CPU (``--device cpu``): its
``main`` in this process on ``configs/enerf/synthetic_smoke.yaml`` and
``synthetic_smoke_human.yaml`` (32x64 frames, 2 epochs of 2 steps), the
checkpoints it writes in the reference's layout, the resume at the next
epoch, the validation every ``eval_ep`` epochs, ``--test``, the saved
config read back by PyYAML and by the port's reader, and one train step of
``ENeRFHuman`` as ``configs/enerf/zjumocap/zjumocap_train.yaml`` builds it,
on a ZJU-MoCap-layout scene through the port's dataset. The JAX package's
``train.py`` compiles a JAX model for the same work; the port's train step
is held against JAX's in ``tests/test_torch_train_step.py``."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from enerf_tpu_torch.config import asdict, make_cfg
from enerf_tpu_torch.train.__main__ import main
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs" / "enerf"


def _argv(cfg_name, workspace, *extra):
    return ["--device", "cpu", "--cfg_file", str(CONFIGS / cfg_name),
            "workspace", str(workspace), "train.epoch", "2", "ep_iter", "2",
            "train.num_workers", "1", "test_dataset.length", "1",
            "train_dataset.input_h_w", "[32, 64]",
            "test_dataset.input_h_w", "[32, 64]", "fix_random", "True",
            *extra]


def _run(argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = main(argv)
    return res, printed.getvalue()


@pytest.fixture(scope="module", params=["synthetic_smoke.yaml",
                                        "synthetic_smoke_human.yaml"])
def trained(request, tmp_path_factory):
    """Two epochs of two steps, a checkpoint and a validation after each."""
    workspace = tmp_path_factory.mktemp("train_ws")
    argv = _argv(request.param, workspace)
    (state, trainer, vals), printed = _run(argv)
    cfg_dir = Path(make_cfg(argv[3], argv[4:]).trained_model_dir) / "config"
    saved = {f.name: f.read_text() for f in cfg_dir.iterdir()}
    return request.param, workspace, state, vals, printed, saved


def test_train_cli_checkpoints_and_validation(trained):
    """The reference's checkpoint layout (``{epoch}.pth`` of net, optim,
    scheduler, recorder, epoch) after each epoch, the steps taken, and a
    validation with the config's evaluator after each epoch."""
    name, workspace, state, vals, printed, _ = trained
    cfg = make_cfg(str(CONFIGS / name), ["workspace", str(workspace)])
    model_dir = Path(cfg.trained_model_dir)
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["0.pth",
                                                               "1.pth"]
    ckpt = torch.load(model_dir / "1.pth", weights_only=True)
    assert set(ckpt) == {"net", "optim", "scheduler", "recorder", "epoch"}
    assert ckpt["epoch"] == 1 and state.step == 4
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(ckpt["net"][k], v, rtol=0, atol=0)
    assert len(vals) == 2
    assert all(np.isfinite(v["psnr"]) and np.isfinite(v["psnr_1"])
               for v in vals)
    assert "val loss stats" in printed and "epoch: 1" in printed


def test_train_cli_resumes_and_tests(trained):
    """A second run resumes at epoch 2 and writes ``2.pth``; ``--test``
    evaluates the newest checkpoint."""
    name, workspace, _, _, _, _ = trained
    argv = _argv(name, workspace, "eval_ep", "100")
    argv[argv.index("train.epoch") + 1] = "3"
    (state2, _, vals), printed = _run(argv)
    assert "resumed at epoch 2" in printed and vals == []
    assert state2.step == 6
    cfg = make_cfg(str(CONFIGS / name), ["workspace", str(workspace)])
    assert (Path(cfg.trained_model_dir) / "2.pth").is_file()
    res, printed = _run(["--test", *_argv(name, workspace)])
    assert "loaded checkpoint epoch 2" in printed
    assert res["frames"] == 1 and np.isfinite(res["metrics"]["psnr"])


def test_saved_config_reads_back(trained):
    """``config/train_config.yaml`` loads with ``yaml.safe_load`` as the
    port's ``asdict`` of the run's config, and the port's reader gives the
    same ``Config``; ``train_cmd.txt`` holds the command line."""
    name, workspace, _, _, _, saved = trained
    argv = _argv(name, workspace)
    cfg = make_cfg(argv[3], argv[4:])
    assert yaml.safe_load(saved["train_config.yaml"]) == asdict(cfg)
    path = workspace / "train_config.yaml"
    path.write_text(saved["train_config.yaml"])
    assert make_cfg(str(path)) == cfg
    assert saved["train_cmd.txt"].endswith(" ".join(argv))


def test_train_cli_distributed_needs_launcher(capsys, monkeypatch):
    """``--distributed`` without ``torch.distributed.run``'s environment
    exits 2 with a message (and joins no process group)."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as exc:
        main(["--distributed", "--device", "cpu"])
    err = capsys.readouterr().err
    assert exc.value.code == 2 and "torch.distributed.run" in err, err
    assert not torch.distributed.is_initialized()


def test_zjumocap_train_config_takes_a_step(tmp_path):
    """``zjumocap_train.yaml`` (cut to a 64x64 scene, fewer rays, 16-pixel
    patches) builds ``ENeRFHuman`` and takes one step of the port's train
    step on a batch of the port's ZJU-MoCap dataset (train split)."""
    from enerf_tpu_torch import build_model
    from enerf_tpu_torch.datasets.loader import make_data_loader
    from enerf_tpu_torch.models.enerf_human import ENeRFHuman
    from enerf_tpu_torch.train import create_train_state, make_train_step
    from tests.test_torch_datasets_video import _write_zjumocap

    _write_zjumocap(str(tmp_path))
    cfg = make_cfg(str(CONFIGS / "zjumocap" / "zjumocap_train.yaml"), [
        "workspace", str(tmp_path), "train_dataset.input_ratio", "1.0",
        "train_dataset.frames", "[0, -1, 1]", "train.num_workers", "1",
        "train_dataset.input_views", "[0, -1, 1]",
        "train_dataset.render_views", "[0, -1, 1]",
        "enerf.cas_config.num_rays", "[256, 1024]",
        "enerf.cas_config.patch_size", "[-1, 16]", "fix_random", "True"])
    batch = next(iter(make_data_loader(cfg, "train", max_iter=1)))
    model = build_model(cfg, device="cpu", train=True)
    assert type(model) is ENeRFHuman
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, tuple(batch["src_inps"].shape[2:4]))
    before = [p.detach().clone() for p in model.parameters()]
    state, stats = step(state, batch)
    assert state.step == 1 and np.isfinite(float(stats["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
