"""Interactive visualizer (reference lib/visualizers/enerf_interactive.py);
counterpart of ``enerf_tpu/eval/visualizer_interactive.py``: the last
level's rgb as an (H, W, 3) image for the GUI's frame. The outputs arrive
as numpy arrays, the batch as the interactive dataset's tensors."""

from __future__ import annotations

from typing import Dict

import numpy as np

from enerf_tpu_torch.config import Config


class Visualizer:
    def __init__(self, cfg: Config):
        self.cfg = cfg

    def visualize(self, output: Dict[str, np.ndarray], batch: Dict) -> Dict:
        H, W = batch["src_inps"].shape[2:4]
        i = self.cfg.enerf.cas_config.num - 1
        pred = np.asarray(output[f"rgb_level{i}"])[0].reshape(H, W, 3)
        return {"pred": pred}

    def summarize(self) -> None:
        pass
