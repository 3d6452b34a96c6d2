"""Human evaluator (reference lib/evaluators/enerf_human.py); counterpart
of ``enerf_tpu/eval/evaluator_human.py``: metrics restricted to
``mask_at_box`` — PSNR over masked pixels, SSIM/LPIPS over the mask's
bounding rectangle (``bounding_rect``, numpy for ``cv2.boundingRect``).
With ``cfg.save_result`` each rendered level's [gt | pred], unmasked,
clipped and truncated to u8, is written as the base evaluator names it."""

from __future__ import annotations

from typing import Dict

import numpy as np

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.eval import evaluator, metrics
from enerf_tpu_torch.eval.lpips import DEFAULT_WEIGHTS


class Evaluator(evaluator.Evaluator):
    def __init__(self, cfg: Config, device=None,
                 lpips_path: str = DEFAULT_WEIGHTS):
        super().__init__(cfg, device, lpips_path)
        self._window_warned = False

    def _check_window(self, masks: np.ndarray, h: int, w: int) -> None:
        """Detect an undersized ``mask_window_hw``: the model's static
        window render (models/enerf_human.py:_render_window) leaves masked
        pixels OUTSIDE the window rendered black, silently biasing
        PSNR/SSIM. Mirrors the model's snap-down-to-16 origin: if the mask
        extent from the snapped origin exceeds the window, the frame's
        metrics are corrupted — say so loudly (once)."""
        if self._window_warned or self.cfg.enerf.mask_window_hw is None:
            return
        wh, ww = self.cfg.enerf.mask_window_hw
        snap = 16
        for m in masks:
            ys, xs = np.nonzero(m > 0)
            if ys.size == 0:
                continue
            ext_h = ys.max() + 1 - (ys.min() // snap) * snap
            ext_w = xs.max() + 1 - (xs.min() // snap) * snap
            if ext_h > wh or ext_w > ww:
                print(f"[evaluator_human] WARNING: mask bbox extent "
                      f"({ext_h}, {ext_w}) exceeds mask_window_hw "
                      f"({wh}, {ww}) — pixels outside the window render "
                      f"black and PSNR/SSIM for such frames are biased. "
                      f"Raise enerf.mask_window_hw.", flush=True)
                self._window_warned = True
                return

    def evaluate(self, output: Dict[str, np.ndarray], batch: Dict) -> None:
        cfg = self.cfg
        cas = cfg.enerf.cas_config
        B, S, H, W = np.asarray(batch["src_inps"]).shape[:4]
        meta = batch.get("meta", {})
        scenes = meta.get("scene", ["scene"] * B)
        for i in range(cas.num):
            if not cas.render_if[i]:
                continue
            rs = cas.render_scale[i]
            h, w = int(H * rs), int(W * rs)
            pred_rgb = np.asarray(output[f"rgb_level{i}"]).reshape(B, h, w, 3)
            gt_rgb = np.asarray(batch[f"rgb_{i}"]).reshape(B, h, w, 3).copy()
            last = i == cas.num - 1
            if last:
                masks = np.asarray(batch["mask_at_box"]).reshape(B, h, w)
                self._check_window(masks, h, w)
            else:
                masks = np.ones((B, h, w), np.float32)

            for b in range(B):
                if cfg.save_result:
                    img = np.concatenate([gt_rgb[b], pred_rgb[b]], axis=1)
                    self._save((np.clip(img, 0, 1) * 255).astype(np.uint8),
                               scenes[b], meta, b)
                m = masks[b] == 1
                gt_b, pred_b = gt_rgb[b].copy(), pred_rgb[b].copy()
                gt_b[~m] = 0.0
                pred_b[~m] = 0.0
                x, y, ww, hh = evaluator.bounding_rect(m.astype(np.uint8))
                gt_c = gt_b[y:y + hh, x:x + ww]
                pred_c = pred_b[y:y + hh, x:x + ww]
                self._record(f"{scenes[b]}_level{i}", last,
                             metrics.psnr(gt_b[m], pred_b[m]),
                             metrics.ssim(gt_c, pred_c), gt_c, pred_c)

    def summarize(self) -> Dict[str, float]:
        ret = self._result()
        print("=" * 30)
        self._print_scenes()
        print(ret)
        print("=" * 30)
        self._reset()
        return ret
