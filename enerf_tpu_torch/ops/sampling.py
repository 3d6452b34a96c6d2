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


def bilinear_sample_2d_view_last(imgs: torch.Tensor, x: torch.Tensor,
                                 y: torch.Tensor,
                                 padding_mode: str = "zeros") -> torch.Tensor:
    """Like ``bilinear_sample_2d_multi`` but coords are (..., V) with the
    view axis last; returns (..., V, C)."""
    xs = torch.movedim(x, -1, 0)
    ys = torch.movedim(y, -1, 0)
    return torch.movedim(bilinear_sample_2d_multi(imgs, xs, ys, padding_mode),
                         0, -2)


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
