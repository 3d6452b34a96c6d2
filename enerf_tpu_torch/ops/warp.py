"""Plane-sweep homography warp + variance cost volume; counterpart of
``enerf_tpu/ops/warp.py`` (``build_cost_volume``,
``build_cost_volume_crop``).

Layouts: features (B, S, H_s, W_s, C), volume (B, D, H_t, W_t, C). Padded
source views are excluded by ``view_mask``. Each function is one CUDA
kernel on the card (``ops/kernels/cost_volume.py``); on the CPU it runs the
kernel's plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from enerf_tpu_torch.ops.kernels.cost_volume import fused_cost_volume


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
