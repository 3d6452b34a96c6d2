"""ENeRF evaluator (reference lib/evaluators/enerf.py:16-140); counterpart
of ``enerf_tpu/eval/evaluator.py``, with the same metrics, keys, per-scene
lines and ``summarize()`` dict.

Per-level, per-image PSNR/SSIM/LPIPS with mask-zeroed eval (DTU depth>0
mask), optional 10% border crop (LLFF ``eval_center``), per-scene
breakdown, and depth metrics on the 5 MVSNeRF scenes. Outputs and batches
arrive as numpy arrays (``Trainer.val`` copies the outputs to the host);
LPIPS runs on the evaluator's device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.eval import metrics
from enerf_tpu_torch.eval.lpips import (
    DEFAULT_WEIGHTS,
    LPIPSMetric,
    lpips_skip_notice,
)

EVAL_DEPTH_SCENES = ("scan1", "scan8", "scan21", "scan103", "scan110")


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` in
    numpy: destination pixel (y, x) takes source pixel (floor(y / fy),
    floor(x / fx)), fx = w / W, clamped into the source, as OpenCV's
    ``resizeNN`` computes it."""
    H, W = img.shape[:2]
    h, w = hw
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64),
                    H - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64),
                    W - 1)
    return img[ys[:, None], xs[None, :]]


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect`` of a 2-D mask in numpy: (x, y, w, h) of the
    smallest upright rectangle holding its non-zero pixels; (0, 0, 0, 0)
    when there are none."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return 0, 0, 0, 0
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) + 1 - x0, int(ys.max()) + 1 - y0


class Evaluator:
    def __init__(self, cfg: Config, device=None,
                 lpips_path: str = DEFAULT_WEIGHTS):
        """``device`` and ``lpips_path``: where LPIPS runs (default the GPU)
        and its weights (without the file, no LPIPS is reported).
        ``cfg.save_result`` raises: writing the result images needs the
        image utilities, which the port does not have yet."""
        if cfg.save_result:
            raise NotImplementedError(
                "save_result is not supported by enerf_tpu_torch's "
                "evaluators: writing result images needs the port's image "
                "utilities (ROADMAP.md, Queue 1, item 8, not ported yet); "
                "set save_result False")
        self.cfg = cfg
        self.lpips_metric = LPIPSMetric(cfg.eval_lpips, lpips_path, device)
        self._reset()
        if cfg.enerf.eval_depth:
            self.abs, self.acc_2, self.acc_10 = [], [], []
            self.mvs_abs, self.mvs_acc_2, self.mvs_acc_10 = [], [], []

    def _reset(self) -> None:
        self.psnrs, self.ssims, self.lpips = [], [], []
        self.scene_psnrs: Dict[str, list] = {}
        self.scene_ssims: Dict[str, list] = {}
        self.scene_lpips: Dict[str, list] = {}

    def _record(self, key: str, last: bool, p: float, s: float,
                gt: np.ndarray, pred: np.ndarray) -> None:
        """PSNR ``p``, SSIM ``s`` and the LPIPS of ``gt`` vs ``pred`` under
        the scene-level ``key``; the image lists take the last level's."""
        self.scene_psnrs.setdefault(key, []).append(p)
        self.scene_ssims.setdefault(key, []).append(s)
        self.scene_lpips.setdefault(key, [])
        if last:
            self.psnrs.append(p)
            self.ssims.append(s)
        lp = self.lpips_metric.score(gt, pred) if self.cfg.eval_lpips else None
        if lp is not None:
            self.scene_lpips[key].append(lp)
            if last:
                self.lpips.append(lp)

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
            gt_rgb = np.asarray(batch[f"rgb_{i}"]).reshape(B, h, w, 3)
            masks = (np.asarray(batch[f"msk_{i}"]).reshape(B, h, w) >= 1)

            if cfg.enerf.eval_center:
                hc, wc = int(h * 0.1), int(w * 0.1)
                pred_rgb = pred_rgb[:, hc:-hc, wc:-wc]
                gt_rgb = gt_rgb[:, hc:-hc, wc:-wc]
                masks = masks[:, hc:-hc, wc:-wc]

            last = i == cas.num - 1
            for b in range(B):
                gt_b = gt_rgb[b].copy()
                pred_b = pred_rgb[b].copy()
                m = masks[b]
                gt_b[~m] = 0.0
                pred_b[~m] = 0.0
                self._record(f"{scenes[b]}_level{i}", last,
                             metrics.psnr_masked(gt_b, pred_b, m),
                             metrics.ssim(gt_b, pred_b), gt_b, pred_b)
                if (cfg.enerf.eval_depth and last
                        and scenes[b] in EVAL_DEPTH_SCENES):
                    self._eval_depth(output, batch, b, h, w, i)

    def _eval_depth(self, output, batch, b, h, w, level):
        nerf_depth = np.asarray(output[f"depth_level{level}"])[b].reshape(h, w)
        mvs_depth = np.asarray(output[f"depth_mvs_level{level}"])[b]
        gt = np.asarray(batch["tar_dpt"])[b].reshape(h, w)
        mvs_gt = resize_nearest(gt, mvs_depth.shape)
        d = metrics.depth_metrics(nerf_depth, gt)
        self.abs.append(d["abs"]); self.acc_2.append(d["acc_2"]); self.acc_10.append(d["acc_10"])
        d = metrics.depth_metrics(mvs_depth, mvs_gt)
        self.mvs_abs.append(d["abs"]); self.mvs_acc_2.append(d["acc_2"]); self.mvs_acc_10.append(d["acc_10"])

    def _result(self) -> Dict[str, float]:
        ret = {"psnr": float(np.mean(self.psnrs)) if self.psnrs else float("nan"),
               "ssim": float(np.mean(self.ssims)) if self.ssims else float("nan")}
        if self.cfg.eval_lpips and self.lpips:
            ret["lpips"] = float(np.mean(self.lpips))
        elif self.cfg.eval_lpips:
            lpips_skip_notice()
        return ret

    def _print_scenes(self) -> None:
        for scene in self.scene_psnrs:
            line = (f"{scene.ljust(16)} psnr: {np.mean(self.scene_psnrs[scene]):.2f} "
                    f"ssim: {np.mean(self.scene_ssims[scene]):.3f}")
            if self.scene_lpips.get(scene):
                line += f" lpips: {np.mean(self.scene_lpips[scene]):.3f}"
            print(line)

    def summarize(self) -> Dict[str, float]:
        ret = self._result()
        print("=" * 30)
        self._print_scenes()
        print("=" * 30)
        print(ret)
        if self.cfg.enerf.eval_depth and self.abs:
            print({k: float(np.mean(getattr(self, k)))
                   for k in ("abs", "acc_2", "acc_10")})
            print({k: float(np.mean(getattr(self, "mvs_" + k)))
                   for k in ("abs", "acc_2", "acc_10")})
            for k in ("abs", "acc_2", "acc_10",
                      "mvs_abs", "mvs_acc_2", "mvs_acc_10"):
                setattr(self, k, [])
        self._reset()
        return ret
