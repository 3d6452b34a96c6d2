"""Variance cost volume: the CUDA kernel ``csrc/cost_volume.cu``, its
wrapper, and its plain PyTorch version.

Replaces ``enerf_tpu/ops/pallas/cost_volume.py:fused_corner_variance``
(and its wide-table twin ``fused_wide_variance``, the same function read
from another gather layout). The TPU path computes warp coordinates and
gathers in XLA and runs only the corner blend + variance in Pallas; the
kernel here fuses the whole of ``build_cost_volume``: per voxel, the
plane-sweep warp ``[x, y, 1, 1/d]·P_s`` for every source view, the
zeros-padded bilinear gather straight from the NHWC feature map, and the
masked cross-view variance Σf²/cnt − (Σf/cnt)².

On a CPU tensor ``fused_cost_volume`` runs the plain version; on a CUDA
tensor it launches the kernel or raises. It refuses inputs that need a
gradient; the training path calls ``cost_volume_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from enerf_tpu_torch.ops.kernels import _build
from enerf_tpu_torch.ops.sampling import bilinear_sample_2d_multi

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

_C_MAX = 32


def warp_coords(proj_mats: torch.Tensor, depth_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coords for every (d, y, x) of the target volume.

    proj_mats (B, S, 3, 4); depth_values (B, D, H_t, W_t). Returns
    (x_src, y_src), each (B, S, D, H_t, W_t), in pixel units."""
    D, H_t, W_t = depth_values.shape[1:]
    dt, dev = depth_values.dtype, depth_values.device
    R = proj_mats[..., :3]                               # (B, S, 3, 3)
    T = proj_mats[..., 3]                                # (B, S, 3)
    gy, gx = torch.meshgrid(torch.arange(H_t, dtype=dt, device=dev),
                            torch.arange(W_t, dtype=dt, device=dev),
                            indexing="ij")
    base = (R[..., 0, None, None] * gx + R[..., 1, None, None] * gy
            + R[..., 2, None, None])                     # (B, S, 3, H, W)
    pts = (base[:, :, None]
           + T[:, :, None, :, None, None]
           / depth_values[:, None, :, None])             # (B, S, D, 3, H, W)
    z = torch.clamp(pts[:, :, :, 2], min=1e-6)
    return pts[:, :, :, 0] / z, pts[:, :, :, 1] / z


def masked_variance(warped: torch.Tensor,
                    view_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Variance over the view axis 1 of ``warped`` (B, S, ...), counting
    only views with a nonzero mask (count clamped at 1)."""
    if view_mask is None:
        mean = torch.mean(warped, dim=1)
        sq_mean = torch.mean(warped * warped, dim=1)
    else:
        m = view_mask.to(warped.dtype).reshape(
            view_mask.shape[:2] + (1,) * (warped.ndim - 2))
        count = torch.clamp(torch.sum(m, dim=1), min=1.0)
        mean = torch.sum(warped * m, dim=1) / count
        sq_mean = torch.sum(warped * warped * m, dim=1) / count
    return sq_mean - mean * mean


def cost_volume_plain(feats: torch.Tensor, proj_mats: torch.Tensor,
                      depth_values: torch.Tensor,
                      view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: warp coordinates, ``grid_sample`` with
    zeros padding, masked variance. Shapes as ``fused_cost_volume``."""
    B, S, H_s, W_s, C = feats.shape
    D, H_t, W_t = depth_values.shape[1:]
    x_src, y_src = warp_coords(proj_mats, depth_values)
    warped = bilinear_sample_2d_multi(
        feats.reshape(B * S, H_s, W_s, C),
        x_src.reshape(B * S, -1), y_src.reshape(B * S, -1),
        padding_mode="zeros").reshape(B, S, D, H_t, W_t, C)
    return masked_variance(warped, view_mask)


def fused_cost_volume(feats: torch.Tensor, proj_mats: torch.Tensor,
                      depth_values: torch.Tensor,
                      view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Variance cost volume across source views.

    feats (B, S, H_s, W_s, C) f32 NHWC; proj_mats (B, S, 3, 4);
    depth_values (B, D, H_t, W_t); view_mask optional (B, S), 1 for real
    views and 0 for padding. Returns (B, D, H_t, W_t, C) channels-last.

    The kernel has no backward: with gradients enabled, an input that
    requires one raises ``ValueError`` on every device (training calls
    ``cost_volume_plain``)."""
    _build.refuse_grad("cost volume", "cost_volume_plain", feats, proj_mats,
                       depth_values, view_mask)
    if feats.device.type == "cpu":
        return cost_volume_plain(feats, proj_mats, depth_values, view_mask)
    return _launch(feats, proj_mats, depth_values, view_mask)


def _launch(feats, proj_mats, depth_values, view_mask):
    global launches
    req = _build.require
    B, S, H_s, W_s, C = feats.shape
    D, H_t, W_t = depth_values.shape[1:]
    dev = feats.device
    req(dev.type == "cuda", "cost volume kernel needs a CUDA tensor, got {}",
        dev)
    if view_mask is None:
        view_mask = torch.ones(B, S, dtype=torch.float32, device=dev)
    view_mask = view_mask.to(torch.float32)
    for name, t, shape in (("feats", feats, None),
                           ("proj_mats", proj_mats, (B, S, 3, 4)),
                           ("depth_values", depth_values, (B, D, H_t, W_t)),
                           ("view_mask", view_mask, (B, S))):
        req(t.device == dev, "{} is on {}, feats on {}", name, t.device, dev)
        req(t.dtype == torch.float32, "{} must be float32, got {}", name,
            t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(shape is None or tuple(t.shape) == shape,
            "{} has shape {}, expected {}", name, tuple(t.shape), shape)
    req(C % 4 == 0 and 0 < C <= _C_MAX,
        "cost volume kernel takes C a multiple of 4 up to {}, got {}",
        _C_MAX, C)
    req(feats.data_ptr() % 16 == 0, "feats must be 16-byte aligned")

    out = torch.empty(B, D, H_t, W_t, C, dtype=torch.float32, device=dev)
    lib = _build.load_library("cost_volume")
    fn = lib.enerf_cost_volume
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = fn(feats.data_ptr(), proj_mats.data_ptr(), depth_values.data_ptr(),
            view_mask.data_ptr(), out.data_ptr(),
            B, S, H_s, W_s, C, D, H_t, W_t, _build.stream_handle(dev))
    _build.check_rc("cost_volume", rc)
    launches += 1
    return out
