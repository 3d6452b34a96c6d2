"""Plane-sweep homography warp + variance cost volume; counterpart of
``enerf_tpu/ops/warp.py`` (``homo_warp``, ``build_cost_volume``,
``build_cost_volume_crop``).

Layouts: features (B, S, H_s, W_s, C), volume (B, D, H_t, W_t, C). Padded
source views are excluded by ``view_mask``. Each function is one CUDA
kernel on the card (``ops/kernels/cost_volume.py``); on the CPU it runs the
kernel's plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from enerf_tpu_torch.ops.kernels.cost_volume import (
    fused_cost_volume,
    warp_coords,
)


def _bilinear_zeros(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Sample ``img (H, W, C)`` at pixel coords ``x, y (...)``, zeros
    outside, in pixel space with the JAX package's lerp
    (``enerf_tpu/ops/sampling.py:bilinear_sample_2d``): ``F.grid_sample``'s
    normalized coordinates cost a rounding of about 1e-6 px on the way in
    and out."""
    H, W, C = img.shape
    # far-off coordinates: every corner is outside either way
    x = torch.clamp(x, -2.0, float(W + 1))
    y = torch.clamp(y, -2.0, float(H + 1))
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(-1, C)

    def corner(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        v = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return v * inb[..., None].to(img.dtype)

    top = corner(x0i, y0i) * (1 - tx) + corner(x0i + 1, y0i) * tx
    bot = corner(x0i, y0i + 1) * (1 - tx) + corner(x0i + 1, y0i + 1) * tx
    return top * (1 - ty) + bot * ty


def homo_warp(src_feat: torch.Tensor, proj_mat: torch.Tensor,
              depth_values: torch.Tensor) -> torch.Tensor:
    """Warp one source view's features onto the target's depth planes
    (reference utils.py:57-95): src_feat (H_s, W_s, C), proj_mat (3, 4),
    depth_values (D, H_t, W_t) -> (D, H_t, W_t, C), bilinear with zeros
    outside the source image: K1's warp without its variance. The cost
    volume does not use it."""
    x, y = warp_coords(proj_mat[None, None], depth_values[None])
    return _bilinear_zeros(src_feat, x[0, 0], y[0, 0])


def build_cost_volume(feats: torch.Tensor, proj_mats: torch.Tensor,
                      depth_values: torch.Tensor,
                      view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Variance cost volume across source views.

    feats (B, S, H_s, W_s, C); proj_mats (B, S, 3, 4); depth_values
    (B, D, H_t, W_t); view_mask optional (B, S), 1 for real views and 0
    for padding. Returns (B, D, H_t, W_t, C): Σf²/cnt − (Σf/cnt)² over the
    valid views, cnt = max(#valid, 1)."""
    return fused_cost_volume(feats, proj_mats, depth_values, view_mask)


def build_cost_volume_crop(feats: torch.Tensor, proj_mats: torch.Tensor,
                           depth_values: torch.Tensor, xy0: torch.Tensor,
                           crop_hw: Tuple[int, int],
                           view_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The variance cost volume of the (h, w) = ``crop_hw`` window at the
    per-batch origin xy0 (B, 2) int [x0, y0] (a device tensor, volume
    scale): the composite model's fg volume. ``depth_values`` is the full
    (B, D, H_t, W_t); the window's depth planes come from the origin
    clamped into the frame, its warp from the unclamped origin, as in the
    JAX package. Returns (B, D, h, w, C)."""
    return fused_cost_volume(feats, proj_mats, depth_values, view_mask,
                             window=(xy0, crop_hw))
