"""``python -m enerf_tpu_torch.train --distributed`` on the CPU under
``torch.distributed.run`` (2 gloo ranks, ``--device cpu``, one torch thread
each by the launcher's default) on ``configs/enerf/synthetic_smoke.yaml``:
one epoch of 2 steps, a checkpoint and a validation. Rank 0 alone writes:
one checkpoint set, one config snapshot, one record; the checkpoint's net
has the module's own keys (no ``module.`` prefix) and loads into a plain
``build_model(device="cpu")``. Then the port's multi-rank dry run,
``graft_entry.dryrun_multichip(2)``."""

import os
import subprocess
import sys
from pathlib import Path

import torch

from enerf_tpu_torch import build_model
from enerf_tpu_torch.config import make_cfg
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CFG = REPO / "configs" / "enerf" / "synthetic_smoke.yaml"


def test_distributed_cli_rank0_writes_one_checkpoint(tmp_path):
    opts = ["workspace", str(tmp_path), "train.epoch", "1", "ep_iter", "2",
            "train.num_workers", "1", "test_dataset.length", "1",
            "train_dataset.input_h_w", "[32, 64]",
            "test_dataset.input_h_w", "[32, 64]", "fix_random", "True"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "enerf_tpu_torch.train",
         "--distributed", "--device", "cpu", "--cfg_file", str(CFG), *opts],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-5000:]
    # rank 0 alone prints the step lines and the validation
    assert res.stdout.count("epoch: 0  step: 1 ") == 1, res.stdout
    assert res.stdout.count("val loss stats") == 1, res.stdout

    cfg = make_cfg(str(CFG), opts)
    model_dir = Path(cfg.trained_model_dir)
    assert sorted(p.name for p in model_dir.glob("*.pth")) == ["0.pth"]
    assert sorted(p.name for p in (model_dir / "config").iterdir()) == [
        "train_cmd.txt", "train_config.yaml"]
    ckpt = torch.load(model_dir / "0.pth", map_location="cpu",
                      weights_only=True)
    assert ckpt["epoch"] == 0 and ckpt["scheduler"]["last_epoch"] == 2
    assert not any(k.startswith("module.") for k in ckpt["net"])
    model = build_model(cfg, device="cpu")
    assert set(ckpt["net"]) == set(model.state_dict())
    model.load_state_dict(ckpt["net"])
    lines = Path(cfg.record_dir, "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 2          # the first step's and the validation's


def test_dryrun_multichip_two_ranks():
    from enerf_tpu_torch.graft_entry import dryrun_multichip

    assert dryrun_multichip(2).startswith("dryrun_multichip(2): OK")
