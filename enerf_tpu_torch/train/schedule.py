"""Learning-rate schedules; counterpart of ``enerf_tpu/train/schedule.py``
(reference ``lib/train/scheduler.py``, ``lr_scheduler.py:7-75``).

Step-indexed (epoch = step // ep_iter), so a resumed run continues exactly
from its step count. The optimizer takes them through a ``LambdaLR`` that
is stepped once per optimizer step (``train/state.py``).
"""

from __future__ import annotations

from typing import Callable

from enerf_tpu_torch.config import SchedulerConfig


def lr_factor(sched: SchedulerConfig, ep_iter: int) -> Callable[[int], float]:
    """step → multiplier of the base learning rate."""
    milestones = sorted(sched.milestones)

    def decays(epoch: int) -> int:
        return sum(epoch >= m for m in milestones)

    if sched.type == "exponential":
        # γ^(epoch / decay_epochs), a continuous exponent stepped per epoch
        # (ExponentialLR.get_lr, lr_scheduler.py:70-75)
        return lambda step: sched.gamma ** ((step // ep_iter)
                                            / sched.decay_epochs)
    if sched.type == "multi_step":
        return lambda step: sched.gamma ** decays(step // ep_iter)
    if sched.type == "warmup_multi_step":
        # linear warmup from warmup_factor over warmup_iters epochs, then
        # multi-step decay (lr_scheduler.py:7-50)
        wf, wi = sched.warmup_factor, sched.warmup_iters

        def fn(step: int) -> float:
            epoch = step // ep_iter
            alpha = min(max(epoch / max(wi, 1), 0.0), 1.0)
            warmup = wf * (1 - alpha) + alpha if epoch < wi else 1.0
            return warmup * sched.gamma ** decays(epoch)
        return fn
    raise ValueError(f"unknown scheduler type {sched.type}")


def make_lr_schedule(base_lr: float, sched: SchedulerConfig,
                     ep_iter: int) -> Callable[[int], float]:
    """step → learning rate."""
    factor = lr_factor(sched, ep_iter)
    return lambda step: base_lr * factor(step)
