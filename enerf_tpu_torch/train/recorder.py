"""Metrics recorder; counterpart of ``enerf_tpu/train/recorder.py``
(reference ``lib/train/recorder.py``): window-smoothed scalars and a JSONL
log, ``scalars.jsonl`` under ``cfg.record_dir``. In a data-parallel run
only rank 0 touches the log.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import defaultdict, deque
from typing import Dict

import numpy as np

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.parallel.dist import is_main


class SmoothedValue:
    """The median over the last ``window_size`` values and the mean of all
    of them (reference recorder.py:10-37)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        v = float(value)
        self.deque.append(v)
        self.count += 1
        self.total += v

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.median:.4f} ({self.global_avg:.4f})"


class Recorder:
    def __init__(self, cfg: Config, resume: bool = True):
        self.step = 0
        self.scalars: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.record_dir = cfg.record_dir
        self.path = os.path.join(self.record_dir, "scalars.jsonl")
        if not is_main():
            return
        if not resume and os.path.exists(self.record_dir):
            # a fresh run starts a fresh log (reference recorder.py:53-55)
            shutil.rmtree(self.record_dir, ignore_errors=True)
        os.makedirs(self.record_dir, exist_ok=True)

    def update(self, stats: Dict[str, float]) -> None:
        for k, v in stats.items():
            self.scalars[k].update(float(v))

    def record(self, prefix: str = "train") -> None:
        """Append the windowed medians as one JSON line (rank 0 only)."""
        if not is_main():
            return
        payload = {f"{prefix}/{k}": v.median for k, v in self.scalars.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": self.step, **payload}) + "\n")

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, sd) -> None:
        self.step = sd.get("step", 0)

    def __str__(self):
        keys = ["loss", "psnr_1", "color_mse_1", "data_time", "batch_time"]
        return "  ".join(f"{k}: {self.scalars[k]}" for k in keys
                         if k in self.scalars)
