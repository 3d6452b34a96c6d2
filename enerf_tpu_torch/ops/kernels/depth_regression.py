"""Probabilistic depth regression: the CUDA kernel
``csrc/depth_regression.cu``, its wrapper, its autograd Function, and its
plain PyTorch version.

Replaces ``enerf_tpu/ops/pallas/reductions.py:depth_regression_pallas``
and its ``custom_vjp`` wrapper ``depth_regression_fused``: per pixel over
the D planes, a softmax of the logits, the expectation of the plane values
(disparity when ``depth_inv``) and their standard deviation. As in the JAX
package, the forward is the kernel and the backward recomputes the plain
version under autograd; inputs are float32 or bfloat16, the arithmetic is
float32 either way, and the outputs are in the input type.

``depth_regression`` runs the kernel on a CUDA tensor (or raises) and the
plain version on a CPU tensor, through its autograd Function.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from enerf_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

WARP = 32                   # pixels a pixel tile, one per lane
MAX_GROUPS = 32             # warps a block: 1024 threads
MAX_PLANES_PER_THREAD = 8
# Warps a block should hold at least: pixel tiles are added to a block of
# fewer plane groups (one-warp blocks leave level 1 slower).
BLOCK_WARPS = 4
_DTYPES = (torch.float32, torch.bfloat16)
# enerf_depth_regression(logits, values, depth, std, B, D, H, W, depth_inv,
# bf16, planes_per_thread, groups, tiles, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def depth_regression_plain(depth_prob: torch.Tensor,
                           depth_values: torch.Tensor,
                           depth_inv: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (``enerf_tpu/ops/depth.py``'s jnp path,
    in float32 as the TPU kernel computes): softmax over dim 1, optional
    disparity, central moments; the outputs in ``depth_prob``'s type.
    Arguments as ``depth_regression``."""
    dtype = depth_prob.dtype
    prob = torch.softmax(depth_prob.float(), dim=1)
    depth_values = depth_values.float()
    if depth_inv:
        depth_values = 1.0 / torch.clamp(depth_values, min=1e-6)
    depth = torch.sum(prob * depth_values, dim=1)
    var = torch.sum(prob * (depth_values - depth[:, None]) ** 2, dim=1)
    std = torch.sqrt(torch.clamp(var, min=1e-10))
    return depth.to(dtype), std.to(dtype)


class DepthRegression(torch.autograd.Function):
    """Kernel forward (plain on the CPU), plain-recompute backward."""

    @staticmethod
    def forward(ctx, depth_prob, depth_values, depth_inv: bool):
        ctx.save_for_backward(depth_prob, depth_values)
        ctx.depth_inv = depth_inv
        if depth_prob.device.type == "cpu":
            return depth_regression_plain(depth_prob, depth_values, depth_inv)
        return _launch(depth_prob, depth_values, depth_inv)

    @staticmethod
    def backward(ctx, g_depth, g_std):
        depth_prob, depth_values = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip((depth_prob, depth_values), need)]
        with torch.enable_grad():
            outs = depth_regression_plain(*inputs, ctx.depth_inv)
            wrt = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(outs, wrt, (g_depth, g_std)))
        return (*(next(grads) if n else None for n in need), None)


def depth_regression(depth_prob: torch.Tensor, depth_values: torch.Tensor,
                     depth_inv: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-expectation depth + std over the plane axis.

    depth_prob (logits), depth_values (B, D, H, W), both float32 or both
    bfloat16. With ``depth_inv`` the plane values are converted to
    disparity first. Returns (depth, std), each (B, H, W) in the input
    type, in the pdf's native space; differentiable in both inputs."""
    return DepthRegression.apply(depth_prob, depth_values, depth_inv)


def plan(D: int, n_pixels: int) -> Tuple[int, int, int, int]:
    """The kernel's launch plan: (planes per thread, plane groups a block,
    pixel tiles a block, blocks). A warp covers ``WARP`` pixels and one
    group of planes; a block holds every group of its pixel tiles.

    Each thread takes ``MAX_PLANES_PER_THREAD`` planes, or the least power
    of two >= D when D is smaller, so the groups are ceil(D / planes) (at
    most ``MAX_GROUPS``: past that a thread walks several chunks). A block
    of fewer than ``BLOCK_WARPS`` groups takes that many more pixel
    tiles."""
    ppt = min(MAX_PLANES_PER_THREAD, 1 << (D - 1).bit_length())
    groups = min(-(-D // ppt), MAX_GROUPS)
    tiles = max(1, BLOCK_WARPS // groups)
    tiles_total = -(-n_pixels // WARP)
    return ppt, groups, tiles, -(-tiles_total // tiles)


def _launch(depth_prob, depth_values, depth_inv):
    global launches
    req = _build.require
    dev = depth_prob.device
    req(dev.type == "cuda", "depth regression kernel needs a CUDA tensor, "
        "got {}", dev)
    req(depth_prob.ndim == 4, "depth_prob must be (B, D, H, W), got {}",
        tuple(depth_prob.shape))
    B, D, H, W = depth_prob.shape
    dtype = depth_prob.dtype
    req(dtype in _DTYPES, "depth_prob must be float32 or bfloat16, got {}",
        dtype)
    for name, t in (("depth_prob", depth_prob), ("depth_values", depth_values)):
        req(t.device == dev, "{} is on {}, depth_prob on {}", name, t.device,
            dev)
        req(t.dtype == dtype, "{} is {}, depth_prob {}", name, t.dtype, dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(tuple(t.shape) == (B, D, H, W), "{} has shape {}, expected {}",
            name, tuple(t.shape), (B, D, H, W))
    req(D > 0, "depth regression needs at least one plane")
    ppt, groups, tiles, _ = plan(D, B * H * W)

    depth = torch.empty(B, H, W, dtype=dtype, device=dev)
    std = torch.empty(B, H, W, dtype=dtype, device=dev)
    fn = _build.load_function("depth_regression", "enerf_depth_regression",
                              _ARGTYPES)
    rc = fn(depth_prob.data_ptr(), depth_values.data_ptr(), depth.data_ptr(),
            std.data_ptr(), B, D, H, W, int(depth_inv),
            int(dtype == torch.bfloat16), ppt, groups, tiles,
            _build.stream_handle(dev))
    _build.check_rc("depth_regression", rc)
    launches += 1
    return depth, std
