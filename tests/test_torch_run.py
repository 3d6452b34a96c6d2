"""``python -m enerf_tpu_torch.run`` on the CPU (``--device cpu``) over
``configs/enerf/synthetic_smoke.yaml``: the module entry in a fresh
interpreter, and one evaluation, whose timed frames are checked and whose
metrics equal ``Trainer.val`` with the evaluator the config names over the
same loader and the CLI's (seeded) model. The JAX package's ``run.py``
compiles a JAX model for the same work, so the reference here is the
port's own ``Trainer.val``, held against JAX in
``tests/test_torch_eval.py``."""

import contextlib
import copy
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from enerf_tpu_torch.config import make_cfg
from enerf_tpu_torch.run import main
from enerf_tpu_torch.utils.video import read_mp4
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / "configs" / "enerf" / "synthetic_smoke.yaml")


def _argv(run_type, workspace):
    return ["--type", run_type, "--device", "cpu", "--cfg_file", SMOKE,
            "workspace", str(workspace)]


def test_run_module_entry(tmp_path, capsys):
    """``python -m enerf_tpu_torch.run --type dataset`` iterates the test
    loader in a fresh interpreter (one torch thread, as a test worker's
    share) without importing JAX, a YAML package, OpenCV or imageio; and
    ``--type visualize`` runs: a frame a test view into ``color.mp4`` and
    ``depth.mp4`` (``tests/test_torch_visualize.py`` holds the videos and
    the visualizer to JAX's)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['run'] + sys.argv[1:]\n"
            "runpy.run_module('enerf_tpu_torch.run', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "    ('jax', 'flax', 'enerf_tpu', 'yaml', 'cv2', 'imageio'))\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code,
                          *_argv("dataset", tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "batches: 4" in res.stdout and "LOADED []" in res.stdout
    res = main(_argv("visualize", tmp_path))
    assert res["frames"] == 4 == len(res["visualize_ms"])
    assert "encode host ms" in capsys.readouterr().out
    result_dir = Path(make_cfg(SMOKE, ["workspace", str(tmp_path)]).result_dir)
    for name in ("color.mp4", "depth.mp4"):
        frames, fps = read_mp4(str(result_dir / name))
        assert len(frames) == 4 and frames[0].shape == (58, 78, 3)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """One ``--type evaluate`` run of the CLI, with what it printed."""
    workspace = tmp_path_factory.mktemp("workspace")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = main(_argv("evaluate", workspace))
    return res, printed.getvalue(), workspace


def test_run_evaluate_matches_trainer_val(evaluated):
    """The timed frames, the first frame's outputs, the bytes uploaded, and
    the metrics, which equal ``Trainer.val`` with the config's evaluator
    over the same loader and the CLI's model."""
    from enerf_tpu_torch.datasets.loader import make_data_loader
    from enerf_tpu_torch.factory import make_evaluator
    from enerf_tpu_torch.train import Trainer, create_train_state

    res, printed, workspace = evaluated
    assert res["frames"] == 4 == len(res["loader_host_ms"])
    assert res["timer"] == "host clock" and res["fps"] > 0
    assert "using the seeded random init" in printed
    out = res["first_out"]
    assert out["rgb_level1"].shape == (1, 64 * 96, 3)
    assert all(np.isfinite(v).all() for v in out.values())
    assert set(res["metrics"]) == {"psnr", "ssim"}
    # the bytes of the device inputs only: no tar_img on the upload
    batch = res["first_batch"]
    assert res["upload_bytes"][0] == sum(
        4 * v.size for k, v in batch.items()
        if isinstance(v, np.ndarray) and k != "tar_img")

    cfg = make_cfg(SMOKE, ["workspace", str(workspace)])
    val = Trainer(cfg, train_step=None).val(
        0, create_train_state(cfg, res["model"]),
        make_data_loader(cfg, "test"),
        evaluator=make_evaluator(cfg, device="cpu"))
    assert res["metrics"] == pytest.approx(
        {k: val[k] for k in res["metrics"]}, rel=1e-9, abs=1e-9)


def test_run_loads_the_checkpoint(evaluated, tmp_path, capsys):
    """With a checkpoint under ``trained_model_dir`` the CLI renders with
    its weights, not the seeded ones."""
    import enerf_tpu_torch as et
    from enerf_tpu_torch.train import create_train_state
    from enerf_tpu_torch.train.checkpoint import save_model

    res, _, _ = evaluated
    model = copy.deepcopy(res["model"]).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    cfg = make_cfg(SMOKE, ["workspace", str(tmp_path)])
    save_model(cfg.trained_model_dir, create_train_state(cfg, model), 7)
    capsys.readouterr()
    got = main(_argv("network", tmp_path))
    assert "loaded checkpoint epoch 7" in capsys.readouterr().out
    np.testing.assert_allclose(
        et.render(model, res["first_batch"])["rgb_level1"].numpy(),
        got["first_out"]["rgb_level1"], rtol=0, atol=1e-6)
    assert not np.allclose(got["first_out"]["rgb_level1"],
                           res["first_out"]["rgb_level1"])
