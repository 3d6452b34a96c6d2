"""Trainer loop; counterpart of ``enerf_tpu/train/trainer.py`` (reference
``lib/train/trainers/trainer.py:44-127``): the epoch loop over an iterable
of batches with the eta / lr console line, and validation over another.
In a data-parallel run only rank 0 prints and records
(``enerf_tpu/train/trainer.py:68,75,102``).
"""

from __future__ import annotations

import datetime
import time
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from enerf_tpu_torch import render
from enerf_tpu_torch.config import Config
from enerf_tpu_torch.parallel.dist import is_main, unwrap
from enerf_tpu_torch.train.recorder import Recorder
from enerf_tpu_torch.train.schedule import make_lr_schedule
from enerf_tpu_torch.train.state import TrainState
from enerf_tpu_torch.utils.profiling import span


def _mem_str(device: torch.device) -> str:
    """Peak device memory for the console line (the reference logs torch's
    max_memory_allocated, trainer.py:85); nothing on the CPU."""
    if device.type != "cuda":
        return ""
    return f"  max_mem: {torch.cuda.max_memory_allocated(device) / 2**20:.0f}MiB"


def _readback(out: Dict[str, torch.Tensor], stage_hook
              ) -> Dict[str, np.ndarray]:
    """The outputs as host numpy, in the span ``val.readback``. The
    previous batch's arrays stay alive until these exist, as when the copy
    was inline: freed first, the evaluator's numpy SSIM and casts ran ~25 %
    slower on the card's host (12.4 → 15.9 ms a channel's SSIM)."""
    with span("val.readback", stage_hook):
        return {k: v.cpu().numpy() for k, v in out.items()}


class Trainer:
    def __init__(self, cfg: Config, train_step: Callable,
                 recorder: Recorder = None):
        self.cfg = cfg
        self.train_step = train_step
        self.recorder = recorder or Recorder(cfg, resume=cfg.resume)
        self.lr_fn = make_lr_schedule(cfg.train.lr, cfg.train.scheduler,
                                      cfg.ep_iter)

    def train_epoch(self, epoch: int, state: TrainState,
                    loader: Iterable) -> TrainState:
        """At most ``cfg.ep_iter`` steps over ``loader``'s batches."""
        cfg = self.cfg
        device = next(state.model.parameters()).device
        end = time.time()
        for it, batch in enumerate(loader):
            if it >= cfg.ep_iter:
                break
            data_time = time.time() - end
            state, stats = self.train_step(state, batch)
            stats = {k: float(v) for k, v in stats.items()}
            batch_time = time.time() - end
            end = time.time()

            self.recorder.step += 1
            self.recorder.update({**stats, "data_time": data_time,
                                  "batch_time": batch_time})
            if it % cfg.log_interval == 0 and is_main():
                step = state.step
                remaining = (cfg.train.epoch - epoch) * cfg.ep_iter - it
                eta = datetime.timedelta(seconds=int(batch_time * remaining))
                print(f"eta: {eta}  epoch: {epoch}  step: {step}  "
                      f"{self.recorder}  lr: {self.lr_fn(step):.6f}"
                      f"{_mem_str(device)}")
            if it % cfg.record_interval == 0:
                self.recorder.record("train")
        return state

    def val(self, epoch: int, state: TrainState, loader: Iterable,
            evaluator=None, stage_hook=None) -> Dict[str, float]:
        """The per-level color MSE and PSNR over ``loader``'s batches, in
        eval mode, with ``evaluator``'s metrics when one is given (reference
        trainer.py:95-127). In a data-parallel run rank 0 calls it alone,
        on the module inside DDP: eval-mode BN makes no collective.
        ``stage_hook``, when given, goes to ``render`` and is called as the
        spans ``val.readback`` (the outputs to host numpy) and
        ``val.evaluate`` (the MSE, the PSNR and ``evaluator``) close."""
        stats_acc: Dict[str, list] = {}
        model = unwrap(state.model)
        model.eval()
        for batch in loader:
            out = _readback(render(model, batch, stage_hook=stage_hook),
                            stage_hook)
            with span("val.evaluate", stage_hook):
                for i in range(self.cfg.enerf.cas_config.num):
                    pred, gt = out.get(f"rgb_level{i}"), batch.get(f"rgb_{i}")
                    if pred is None or gt is None:
                        continue
                    mse = float(np.mean((pred - np.asarray(gt)) ** 2))
                    stats_acc.setdefault(f"color_mse_{i}", []).append(mse)
                    stats_acc.setdefault(f"psnr_{i}", []).append(
                        -10.0 * np.log10(max(mse, 1e-12)))
                if evaluator is not None:
                    evaluator.evaluate(out, batch)
        model.train()
        result = evaluator.summarize() if evaluator is not None else {}
        result = {**{k: float(np.mean(v)) for k, v in stats_acc.items()},
                  **result}
        if result and is_main():
            print("val loss stats: " + "  ".join(
                f"{k}: {v:.4f}" for k, v in sorted(result.items())))
            self.recorder.update(result)
            self.recorder.record("val")
        return result
