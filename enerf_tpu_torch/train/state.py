"""Train state: the model, its optimizer and its learning-rate scheduler;
counterpart of ``enerf_tpu/train/state.py`` (reference
``lib/train/optimizer.py``, ``trainer.py:62``).

The optimizer is the optax chain of the JAX package in torch's terms: the
gradients are clipped by value (``grad_clip_value``, 40) by the train step,
then Adam / RAdam / SGD adds the L2 weight decay to them and takes its
step with ``eps`` from the config, at the learning rate of the step-indexed
schedule.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.train.schedule import lr_factor


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.scheduler.last_epoch


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    t = cfg.train
    if t.optim == "adam":
        return torch.optim.Adam(params, lr=t.lr, eps=t.eps,
                                weight_decay=t.weight_decay)
    if t.optim == "radam":
        return torch.optim.RAdam(params, lr=t.lr, eps=t.eps,
                                 weight_decay=t.weight_decay)
    if t.optim == "sgd":
        return torch.optim.SGD(params, lr=t.lr, weight_decay=t.weight_decay)
    raise ValueError(f"unknown optimizer {t.optim}")


def create_train_state(cfg: Config, model: nn.Module) -> TrainState:
    """A fresh state for ``model`` (already on its device)."""
    optimizer = make_optimizer(cfg, model.parameters())
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lr_factor(cfg.train.scheduler, cfg.ep_iter))
    return TrainState(model, optimizer, scheduler)
