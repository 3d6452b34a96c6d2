"""Depth-plane placement and probabilistic depth regression; counterpart of
``enerf_tpu/ops/depth.py``.

Cascade contract (two levels in the stock config):
- level 0: D planes uniform in *disparity* between the scene near/far
  (``depth_inv[0]=True``); the returned ``near_far`` is in disparity space.
- level 1: per-pixel interval [depth±std] from the previous level's
  disparity pdf, upsampled to the finer volume scale and clamped to the
  previous volume bounds; planes uniform in *depth*.
"""

from __future__ import annotations

from typing import Tuple

import torch

from enerf_tpu_torch.ops.kernels.depth_regression import (
    depth_regression as kernel_depth_regression,
)
from enerf_tpu_torch.ops.sampling import resize_bilinear, scale_size


def _linspace(D: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, D, dtype=like.dtype, device=like.device)


def init_depth_values(near_far: torch.Tensor, D: int, H: int, W: int,
                      depth_inv: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-level depth planes from the global scene near/far.

    near_far (B, 2). Returns (depth_values (B, D, H, W),
    near_far_out (B, 2, H, W))."""
    B = near_far.shape[0]
    lin = _linspace(D, near_far)
    near = near_far[:, 0:1]
    far = near_far[:, 1:2]
    if depth_inv:
        disp = 1.0 / near + lin[None] * (1.0 / far - 1.0 / near)
        depth_values = 1.0 / disp
    else:
        depth_values = near + lin[None] * (far - near)
    depth_values = depth_values[:, :, None, None].expand(B, D, H, W)
    nf = depth_values[:, [0, D - 1]]
    if depth_inv:
        nf = 1.0 / torch.clamp(nf, min=1e-6)
    return depth_values.contiguous(), nf.contiguous()


def upsample_bounds(depth, std, near_far, up_scale):
    """Align-corners bilinear upsampling of a level's depth (B, h, w), std
    (B, h, w) and near_far (B, 2, h, w) by ``up_scale``."""
    h, w = depth.shape[-2:]
    H, W = scale_size(h, up_scale), scale_size(w, up_scale)
    depth = resize_bilinear(depth[..., None], (H, W))[..., 0]
    std = resize_bilinear(std[..., None], (H, W))[..., 0]
    near_far = torch.movedim(
        resize_bilinear(torch.movedim(near_far, 1, -1), (H, W)), -1, 1)
    return depth, std, near_far


def cascade_depth_values(depth: torch.Tensor, std: torch.Tensor,
                         near_far: torch.Tensor, D: int,
                         depth_inv_prev: bool, depth_inv_cur: bool,
                         up_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-level per-pixel depth planes from the previous level's pdf.

    depth, std (B, h, w) (disparity when depth_inv_prev); near_far
    (B, 2, h, w). Returns (depth_values (B, D, H, W), near_far (B, 2, H, W))."""
    if up_scale != 1.0:
        depth, std, near_far = upsample_bounds(depth, std, near_far, up_scale)

    if depth_inv_prev:
        hi = torch.minimum(depth + std, near_far[:, 0])
        lo = torch.maximum(depth - std, near_far[:, 1])
        near_depth = 1.0 / hi
        far_depth = 1.0 / lo
    else:
        near_depth = torch.maximum(depth - std, near_far[:, 0])
        far_depth = torch.minimum(depth + std, near_far[:, 1])

    lin = _linspace(D, depth)[None, :, None, None]
    if depth_inv_cur:
        disp = (1.0 / near_depth)[:, None] + lin * (
            (1.0 / far_depth)[:, None] - (1.0 / near_depth)[:, None])
        depth_values = 1.0 / disp
    else:
        depth_values = (near_depth[:, None]
                        + lin * (far_depth - near_depth)[:, None])

    nf = depth_values[:, [0, D - 1]]
    if depth_inv_cur:
        nf = 1.0 / torch.clamp(nf, min=1e-6)
    return depth_values.contiguous(), nf.contiguous()


def depth_regression(depth_prob: torch.Tensor, depth_values: torch.Tensor,
                     depth_inv: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-expectation depth + std over the plane axis.

    depth_prob (logits), depth_values (B, D, H, W). With ``depth_inv`` the
    plane values are converted to disparity first. Returns (depth, std),
    each (B, H, W), in the pdf's native space. The CUDA kernel on the card
    (``ops/kernels/depth_regression.py``), its plain version on the CPU;
    differentiable either way."""
    return kernel_depth_regression(depth_prob, depth_values, depth_inv)
