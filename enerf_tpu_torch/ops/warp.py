"""Plane-sweep homography warp + variance cost volume; counterpart of
``enerf_tpu/ops/warp.py``.

Layouts: features (B, S, H_s, W_s, C), volume (B, D, H_t, W_t, C). Padded
source views are excluded by ``view_mask``. The whole function is one CUDA
kernel on the card (``ops/kernels/cost_volume.py``); on the CPU it runs the
kernel's plain version.
"""

from __future__ import annotations

from typing import Optional

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
