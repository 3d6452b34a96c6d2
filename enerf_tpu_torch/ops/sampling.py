"""Align-corners resampling; counterpart of ``enerf_tpu/ops/sampling.py``
(``resize_bilinear``, ``scale_size``, ``bilinear_sample_2d*``,
``trilinear_sample_3d_multi``).

Everything samples in PIXEL coordinates with align_corners semantics
(pixel = (g + 1) / 2 * (size - 1)) and goes through ``F.grid_sample`` /
``F.interpolate``. The JAX package's gather tables (packed 2x2 blocks,
wide tables, segments) exist only to pin the TPU's VMEM and have no
counterpart here.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def scale_size(size: int, scale: float) -> int:
    """F.interpolate's recompute_scale_factor output-size rule:
    floor(in * scale)."""
    return int(np.floor(size * scale))


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True.

    img: (..., H, W, C) channels-last → (..., H_out, W_out, C)."""
    H_out, W_out = out_hw
    H_in, W_in, C = img.shape[-3:]
    if (H_in, W_in) == (H_out, W_out):
        return img
    lead = img.shape[:-3]
    x = img.reshape(-1, H_in, W_in, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(H_out, W_out), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, H_out, W_out, C)


def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The (out_size, in_size) float32 matrix of a bilinear align-corners
    resize along one axis (``enerf_tpu/ops/sampling.py:_interp_matrix``)."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        A[0, 0] = 1.0
        return A
    scale = (in_size - 1) / (out_size - 1)
    for o in range(out_size):
        src = o * scale
        i0 = min(int(np.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        t = src - i0
        A[o, i0] += 1.0 - t
        A[o, i1] += t
    return A


@functools.lru_cache(maxsize=64)
def _interp_tensor(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``interp_matrix`` as a ``dtype`` tensor on ``device``, made once: a
    normal tensor even when first asked for under ``inference_mode``, so
    that a training forward can use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(interp_matrix(in_size, out_size)).to(
            device, dtype)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """Bilinear align-corners resize of ``x`` (N, C, H, W). In float32,
    ``F.interpolate``; in a lower type (the bf16 mode), the JAX package's
    two products with the interpolation matrices, the matrices in ``x``'s
    type and each product rounded to it (``enerf_tpu/ops/sampling.py:
    resize_bilinear``)."""
    if x.dtype == torch.float32:
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=True)
    H_in, W_in = x.shape[-2:]
    Ah, Aw = (_interp_tensor(i, o, x.dtype, x.device)
              for i, o in zip((H_in, W_in), out_hw))
    x = torch.einsum("oh,nchw->ncow", Ah, x)
    return torch.einsum("pw,ncow->ncop", Aw, x)


def _norm(p: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel coordinate → grid_sample's align_corners=True normalized
    coordinate."""
    return p * (2.0 / max(size - 1, 1)) - 1.0


def bilinear_sample_2d_multi(imgs: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor,
                             padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``imgs (V, H, W, C)`` at pixel coords ``x, y (V, ...)``.
    Returns (V, ..., C)."""
    V, H, W, C = imgs.shape
    lead = x.shape
    grid = torch.stack([_norm(x, W), _norm(y, H)], dim=-1).reshape(V, 1, -1, 2)
    out = F.grid_sample(imgs.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out[:, :, 0].permute(0, 2, 1).reshape(*lead, C)


def trilinear_sample_3d_multi(vols: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor, z: torch.Tensor,
                              padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``vols (V, D, H, W, C)`` at voxel coords x (W axis), y (H
    axis), z (D axis), each (V, ...). Returns (V, ..., C)."""
    V, D, H, W, C = vols.shape
    lead = x.shape
    grid = torch.stack([_norm(x, W), _norm(y, H), _norm(z, D)],
                       dim=-1).reshape(V, 1, 1, -1, 3)
    out = F.grid_sample(vols.permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                        padding_mode=padding_mode, align_corners=True)
    return out[:, :, 0, 0].permute(0, 2, 1).reshape(*lead, C)
