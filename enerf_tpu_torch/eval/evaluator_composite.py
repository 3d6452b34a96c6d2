"""Composite (ENeRF-Outdoor) evaluator (reference
lib/evaluators/enerf_composite.py); counterpart of
``enerf_tpu/eval/evaluator_composite.py``: full-frame PSNR/SSIM/LPIPS."""

from __future__ import annotations

from typing import Dict

import numpy as np

from enerf_tpu_torch.eval import evaluator, metrics


class Evaluator(evaluator.Evaluator):
    def evaluate(self, output: Dict[str, np.ndarray], batch: Dict) -> None:
        cas = self.cfg.enerf.cas_config
        B, S, H, W = np.asarray(batch["src_inps"]).shape[:4]
        meta = batch.get("meta", {})
        scenes = meta.get("scene", ["scene"] * B)
        for i in range(cas.num):
            if not cas.render_if[i]:
                continue
            rs = cas.render_scale[i]
            h, w = int(H * rs), int(W * rs)
            pred_rgb = np.asarray(output[f"rgb_level{i}"]).reshape(B, h, w, 3)
            gt_rgb = np.asarray(batch[f"rgb_{i}"]).reshape(B, h, w, 3)
            last = i == cas.num - 1
            for b in range(B):
                self._record(f"{scenes[b]}_level{i}", last,
                             metrics.psnr(gt_rgb[b], pred_rgb[b]),
                             metrics.ssim(gt_rgb[b], pred_rgb[b]),
                             gt_rgb[b], pred_rgb[b])
