"""Variance cost volume: the CUDA kernel ``csrc/cost_volume.cu``, its
wrapper, and its plain PyTorch version.

Replaces ``enerf_tpu/ops/pallas/cost_volume.py:fused_corner_variance``
(and its wide-table twin ``fused_wide_variance``, the same function read
from another gather layout). The TPU path computes warp coordinates and
gathers in XLA and runs only the corner blend + variance in Pallas; the
kernel here fuses the whole of ``build_cost_volume``: per voxel, the
plane-sweep warp ``[x, y, 1, 1/d]·P_s`` for every source view, the
zeros-padded bilinear gather straight from the NHWC feature map, and the
masked cross-view variance Σf²/cnt − (Σf/cnt)². Its crop-window mode
(``window=``) is ``build_cost_volume_crop``, the composite model's fg
volume: the same kernel over a fixed-size window whose origin is a device
tensor.

The features are float32 or bfloat16 (the bf16 compute mode): a
template of one kernel reads them in their type, computes in float32 and
rounds once, when it writes the volume in the features' type, as the TPU
kernel does (``enerf_tpu/ops/pallas/cost_volume.py:58-62,107-119``).

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
from enerf_tpu_torch.ops.window import Window

# Launches of the CUDA kernel since the last reset (set to 0 to reset):
# ``launches`` of its float32 variant, ``launches_bf16`` of its bfloat16 one.
launches = 0
launches_bf16 = 0

# enerf_cost_volume(feats, proj_mats, depth_values, view_mask, origin, out,
# B, S, H_s, W_s, C, D, H_t, W_t, h, w, bf16, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# the feature types the kernel takes, each with the alignment its vector
# loads of 4 channels need
_ALIGN = {torch.float32: 16, torch.bfloat16: 8}

_C_MAX = 32

# (xy0 (B, 2) int [x0, y0], (h, w)): a crop window, origin unclamped
CropWindow = Optional[Tuple[torch.Tensor, Tuple[int, int]]]


def warp_coords(proj_mats: torch.Tensor, depth_values: torch.Tensor,
                xy0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coords for every (d, y, x) of the target volume.

    proj_mats (B, S, 3, 4); depth_values (B, D, h, w); xy0 optional (B, 2)
    int [x0, y0]: the volume is the window whose voxel (y, x) is the
    target pixel (x + x0, y + y0). Returns (x_src, y_src), each (B, S, D,
    h, w), in pixel units."""
    B, D, h, w = depth_values.shape
    dt, dev = depth_values.dtype, depth_values.device
    R = proj_mats[..., :3]                               # (B, S, 3, 3)
    T = proj_mats[..., 3]                                # (B, S, 3)
    gy = torch.arange(h, dtype=dt, device=dev).expand(B, h)
    gx = torch.arange(w, dtype=dt, device=dev).expand(B, w)
    if xy0 is not None:
        gx = gx + xy0[:, 0:1].to(dt)
        gy = gy + xy0[:, 1:2].to(dt)
    gx = gx[:, None, None, None, :]                      # (B, 1, 1, 1, w)
    gy = gy[:, None, None, :, None]                      # (B, 1, 1, h, 1)
    base = (R[..., 0, None, None] * gx + R[..., 1, None, None] * gy
            + R[..., 2, None, None])                     # (B, S, 3, h, w)
    pts = (base[:, :, None]
           + T[:, :, None, :, None, None]
           / depth_values[:, None, :, None])             # (B, S, D, 3, h, w)
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
                      view_mask: Optional[torch.Tensor] = None,
                      window: CropWindow = None) -> torch.Tensor:
    """The plain PyTorch version: warp coordinates, ``grid_sample`` with
    zeros padding, masked variance, in float32 (or the features' wider
    type), the result in the features' type. Arguments as ``fused_cost_volume``. With a window, the
    depth planes are cut from the window's clamped position and the warp
    starts at its unclamped origin, as
    ``enerf_tpu/ops/warp.py:build_cost_volume_crop`` does."""
    dtype = feats.dtype
    feats = feats.to(torch.promote_types(dtype, torch.float32))
    B, S, H_s, W_s, C = feats.shape
    xy0 = None
    if window is not None:
        xy0, (h, w) = window
        depth_values = Window(xy0, (h, w), depth_values.shape[2:]).crop(
            depth_values, planes=True)
    D, h, w = depth_values.shape[1:]
    x_src, y_src = warp_coords(proj_mats, depth_values, xy0)
    warped = bilinear_sample_2d_multi(
        feats.reshape(B * S, H_s, W_s, C),
        x_src.reshape(B * S, -1), y_src.reshape(B * S, -1),
        padding_mode="zeros").reshape(B, S, D, h, w, C)
    return masked_variance(warped, view_mask).to(dtype)


def fused_cost_volume(feats: torch.Tensor, proj_mats: torch.Tensor,
                      depth_values: torch.Tensor,
                      view_mask: Optional[torch.Tensor] = None,
                      window: CropWindow = None) -> torch.Tensor:
    """Variance cost volume across source views.

    feats (B, S, H_s, W_s, C) NHWC, float32 or bfloat16; proj_mats
    (B, S, 3, 4), depth_values (B, D, H_t, W_t) and view_mask (optional,
    (B, S), 1 for real views and 0 for padding) float32. Returns
    (B, D, H_t, W_t, C) channels-last in the features' type; on a CUDA
    tensor any other feature type raises ``ValueError``.

    ``window`` = (xy0, (h, w)): only the (h, w) window of the target frame
    at the per-batch origin xy0 (B, 2) int [x0, y0], a device tensor (the
    composite model's fg crop). Voxel (d, y, x) of the window warps target
    pixel (x + x0, y + y0) and takes its depth plane from the full-frame
    ``depth_values`` at the origin clamped into the frame (the
    ``lax.dynamic_slice`` rule); returns (B, D, h, w, C).

    The kernel has no backward: with gradients enabled, an input that
    requires one raises ``ValueError`` on every device (training calls
    ``cost_volume_plain``)."""
    _build.refuse_grad("cost volume", "cost_volume_plain", feats, proj_mats,
                       depth_values, view_mask)
    if feats.device.type == "cpu":
        return cost_volume_plain(feats, proj_mats, depth_values, view_mask,
                                 window)
    return _launch(feats, proj_mats, depth_values, view_mask, window)


def _launch(feats, proj_mats, depth_values, view_mask, window):
    global launches, launches_bf16
    req = _build.require
    B, S, H_s, W_s, C = feats.shape
    D, H_t, W_t = depth_values.shape[1:]
    dev = feats.device
    req(dev.type == "cuda", "cost volume kernel needs a CUDA tensor, got {}",
        dev)
    req(feats.dtype in _ALIGN, "cost volume kernel takes float32 or bfloat16 "
        "features, got {}", feats.dtype)
    if view_mask is None:
        view_mask = torch.ones(B, S, dtype=torch.float32, device=dev)
    view_mask = view_mask.to(torch.float32)
    tensors = [("feats", feats, None, feats.dtype),
               ("proj_mats", proj_mats, (B, S, 3, 4), torch.float32),
               ("depth_values", depth_values, (B, D, H_t, W_t), torch.float32),
               ("view_mask", view_mask, (B, S), torch.float32)]
    h, w, origin = H_t, W_t, None
    if window is not None:
        origin, (h, w) = window
        origin = origin.to(torch.int32).contiguous()
        req(0 < h <= H_t and 0 < w <= W_t,
            "window {} does not fit the {} frame", (h, w), (H_t, W_t))
        tensors.append(("window origin", origin, (B, 2), torch.int32))
    for name, t, shape, dtype in tensors:
        req(t.device == dev, "{} is on {}, feats on {}", name, t.device, dev)
        req(t.dtype == dtype, "{} must be {}, got {}", name, dtype, t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(shape is None or tuple(t.shape) == shape,
            "{} has shape {}, expected {}", name, tuple(t.shape), shape)
    req(C % 4 == 0 and 0 < C <= _C_MAX,
        "cost volume kernel takes C a multiple of 4 up to {}, got {}",
        _C_MAX, C)
    align = _ALIGN[feats.dtype]
    req(feats.data_ptr() % align == 0, "{} feats must be {}-byte aligned",
        feats.dtype, align)
    req(B * D * h * w * 8 < 2 ** 31 and B * D <= 65535,
        "cost volume kernel takes fewer than 2^28 voxels in at most 65,535 "
        "planes, got {} in {}", B * D * h * w, B * D)

    bf16 = feats.dtype == torch.bfloat16
    out = torch.empty(B, D, h, w, C, dtype=feats.dtype, device=dev)
    fn = _build.load_function("cost_volume", "enerf_cost_volume", _ARGTYPES)
    rc = fn(feats.data_ptr(), proj_mats.data_ptr(), depth_values.data_ptr(),
            view_mask.data_ptr(), None if origin is None else origin.data_ptr(),
            out.data_ptr(), B, S, H_s, W_s, C, D, H_t, W_t, h, w, int(bf16),
            _build.stream_handle(dev))
    _build.check_rc("cost_volume", rc)
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out
