"""Image quality metrics, numerically matched to the reference's oracles;
the port's own copy of ``enerf_tpu/eval/metrics.py`` (numpy and scipy, as
there).

- ``psnr``: skimage.metrics.peak_signal_noise_ratio semantics.
- ``ssim``: skimage.metrics.structural_similarity with the reference's
  call signature ``ssim(gt, pred, multichannel=True)``
  (lib/evaluators/enerf.py:81): uniform 7×7 window, K1=0.01, K2=0.03,
  sample covariance (N/(N-1)), per-channel mean, and — importantly —
  skimage's float-image default ``data_range=2.0`` (it assumes [-1, 1]
  for floats when unspecified). The published SSIM numbers bake in that
  quirk, so it is the default here too.
- depth metrics: abs error + accuracy@2mm/@10mm (enerf.py:89-103).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def psnr_masked(gt: np.ndarray, pred: np.ndarray, mask: np.ndarray,
                data_range: float = 1.0) -> float:
    """PSNR over masked pixels only (reference enerf.py:76
    ``psnr(gt[mask], pred[mask])``)."""
    return psnr(gt[mask], pred[mask], data_range)


def _ssim_single(x: np.ndarray, y: np.ndarray, win: int, data_range: float,
                 K1: float, K2: float) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    NP = win ** x.ndim
    cov_norm = NP / (NP - 1.0)

    filt = lambda a: uniform_filter(a, size=win)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win - 1) // 2
    sl = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[sl].mean())


def ssim(gt: np.ndarray, pred: np.ndarray, data_range: float = 2.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """Multichannel SSIM (channel-last), skimage-compatible."""
    if gt.ndim == 3:
        return float(np.mean([
            _ssim_single(gt[..., c], pred[..., c], win_size, data_range, K1, K2)
            for c in range(gt.shape[-1])]))
    return _ssim_single(gt, pred, win_size, data_range, K1, K2)


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  mask: Optional[np.ndarray] = None) -> dict:
    """abs / acc<2 / acc<10 over valid-depth pixels
    (reference enerf.py:98-103)."""
    if mask is None:
        mask = gt != 0.0
    err = np.abs(pred[mask] - gt[mask])
    return {"abs": float(err.mean()),
            "acc_2": float((err < 2.0).mean()),
            "acc_10": float((err < 10.0).mean())}
