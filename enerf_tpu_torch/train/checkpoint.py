"""Checkpoints; counterpart of ``enerf_tpu/train/checkpoint.py`` in the
reference's own format (``lib/utils/net_utils.py:350-512``).

A checkpoint is ``torch.save`` of ``{net, optim, scheduler, recorder,
epoch}`` as ``{epoch}.pth`` or ``latest.pth`` in the model directory
(``$workspace/trained_model/{task}/{exp_name}``); the 5 newest numbered
files are kept. Files are read with ``torch.load(weights_only=True)``.
``save_trained_config`` writes the command line and the resolved config
beside them (``config/train_cmd.txt``, ``config/train_config.yaml``).
The net is the module's own ``state_dict`` also when it trains inside
``DistributedDataParallel`` (no ``module.`` prefix): the keys stay
``feature_net.*`` / ``cost_reg_{i}.*`` / ``nerf_{i}.*``, the reference's.
In a data-parallel run rank 0 writes; a resume loads on every rank,
before the DDP wrap.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import torch
from torch import nn

from enerf_tpu_torch.config import Config, asdict, dump_yaml
from enerf_tpu_torch.parallel.dist import unwrap
from enerf_tpu_torch.train.state import TrainState

KEEP = 5


def _numbered(model_dir: str):
    return sorted(int(f[:-4]) for f in os.listdir(model_dir)
                  if f.endswith(".pth") and f[:-4].isdigit())


def _pick(model_dir: str, epoch: int = -1) -> Optional[str]:
    """The checkpoint file of ``epoch`` (-1: ``latest.pth``, else the
    newest numbered one) in ``model_dir``, or None when there is none."""
    if not os.path.isdir(model_dir):
        return None
    if epoch >= 0:
        name = f"{epoch}.pth"
    elif os.path.exists(os.path.join(model_dir, "latest.pth")):
        name = "latest.pth"
    else:
        nums = _numbered(model_dir)
        if not nums:
            return None
        name = f"{nums[-1]}.pth"
    return os.path.join(model_dir, name)


def _load(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_model(model_dir: str, state: TrainState, epoch: int,
               recorder=None, last: bool = False) -> str:
    """Save the full train state at ``epoch`` as ``{epoch}.pth``, or as
    ``latest.pth`` when ``last``; drop the oldest numbered file beyond
    ``KEEP``. Returns the path written."""
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "net": unwrap(state.model).state_dict(),
        "optim": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "recorder": recorder.state_dict() if recorder is not None else {},
        "epoch": epoch,
    }
    path = os.path.join(model_dir, "latest.pth" if last else f"{epoch}.pth")
    torch.save(payload, path)
    nums = _numbered(model_dir)
    for old in nums[:max(len(nums) - KEEP, 0)]:
        os.remove(os.path.join(model_dir, f"{old}.pth"))
    return path


def load_model(model_dir: str, state: TrainState, recorder=None,
               resume: bool = True, epoch: int = -1) -> int:
    """Full resume into ``state`` (and ``recorder``) in place; returns the
    next epoch, 0 when there is nothing to resume."""
    path = _pick(model_dir, epoch) if resume else None
    if path is None:
        return 0
    ckpt = _load(path)
    unwrap(state.model).load_state_dict(ckpt["net"])
    state.optimizer.load_state_dict(ckpt["optim"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    if recorder is not None:
        recorder.load_state_dict(ckpt["recorder"])
    return ckpt["epoch"] + 1


def load_network(model: nn.Module, model_dir: str, epoch: int = -1,
                 strict: bool = True) -> int:
    """Weights only, for evaluation: from a model directory (``latest.pth``
    or the newest numbered file, or ``epoch``) or from one ``.pth`` file,
    the reference's included (its ``net`` keys are the port's parameter
    names). Returns the next epoch, 0 when there is nothing to load."""
    path = model_dir if os.path.isfile(model_dir) else _pick(model_dir, epoch)
    if path is None:
        return 0
    ckpt = _load(path)
    model.load_state_dict(ckpt["net"], strict=strict)
    return ckpt.get("epoch", -1) + 1


def load_pretrain(cfg: Config, model: nn.Module) -> bool:
    """Warm start from another experiment's newest checkpoint,
    ``$workspace/trained_model/{task}/{cfg.pretrain}``. Returns whether a
    checkpoint was loaded."""
    if not cfg.pretrain:
        return False
    pre_dir = os.path.join(cfg.workspace, "trained_model", cfg.task,
                           cfg.pretrain)
    return load_network(model, pre_dir) > 0


def save_trained_config(cfg: Config, argv: Optional[List[str]] = None
                        ) -> str:
    """Snapshot the command line (``argv``, default ``sys.argv``) and the
    resolved config beside the checkpoints (reference save_trained_config,
    net_utils.py:485-493): ``config/train_cmd.txt`` and
    ``config/train_config.yaml``, the latter in the YAML subset the port's
    reader reads (``dump_yaml`` of ``asdict``), so that ``make_cfg`` of the
    file gives ``cfg`` again. Returns the config directory."""
    cfg_dir = os.path.join(cfg.trained_model_dir, "config")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "train_cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv if argv is None else argv))
    with open(os.path.join(cfg_dir, "train_config.yaml"), "w") as f:
        f.write(dump_yaml(asdict(cfg)))
    return cfg_dir
