"""The train step; counterpart of ``enerf_tpu/train/step.py``
(``make_train_step``) on one GPU.

One step: forward in training mode (BN by batch statistics, running
statistics updated in place), loss, backward, gradient clip by value,
optimizer step, scheduler step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from enerf_tpu_torch import device_batch
from enerf_tpu_torch.config import Config
from enerf_tpu_torch.train.loss import compute_loss
from enerf_tpu_torch.train.state import TrainState
from enerf_tpu_torch.train.vgg import VGG16Blocks

PhaseHook = Optional[Callable[[str], None]]


def make_train_step(cfg: Config, src_hw: Tuple[int, int],
                    vgg_params: Optional[VGG16Blocks] = None) -> Callable:
    """Returns ``step(state, batch, phase_hook=None) -> (state, stats)``.

    ``batch`` is a dict of numpy arrays or tensors (moved to the model's
    device); ``stats`` holds detached scalar tensors (``loss``,
    ``color_mse_i``, ``psnr_i``, ``perceptual_loss_i``); reading them
    waits for the device. ``phase_hook(name)``, when given, is called right
    after the ``forward`` (loss included), ``backward`` and ``optimizer``
    phases are enqueued — a timer records a CUDA event there."""
    clip = cfg.train.grad_clip_value

    def step(state: TrainState, batch, phase_hook: PhaseHook = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        hook = phase_hook or (lambda name: None)
        model = state.model
        batch = device_batch(batch, next(model.parameters()).device)
        model.train()
        output = model(batch)
        loss, stats = compute_loss(output, batch, cfg.enerf, src_hw,
                                   vgg_params)
        hook("forward")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        hook("backward")
        torch.nn.utils.clip_grad_value_(model.parameters(), clip)
        state.optimizer.step()
        state.scheduler.step()
        hook("optimizer")
        return state, {k: v.detach() for k, v in stats.items()}

    return step
