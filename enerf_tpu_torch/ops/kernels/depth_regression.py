"""Probabilistic depth regression: the CUDA kernel
``csrc/depth_regression.cu``, its wrapper, its autograd Function, and its
plain PyTorch version.

Replaces ``enerf_tpu/ops/pallas/reductions.py:depth_regression_pallas``
and its ``custom_vjp`` wrapper ``depth_regression_fused``: per pixel over
the D planes, a softmax of the logits, the expectation of the plane values
(disparity when ``depth_inv``) and their standard deviation. As in the JAX
package, the forward is the kernel and the backward recomputes the plain
version under autograd.

``depth_regression`` runs the Function on every device: on a CPU tensor
its forward is the plain version, on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from enerf_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0


def depth_regression_plain(depth_prob: torch.Tensor,
                           depth_values: torch.Tensor,
                           depth_inv: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (``enerf_tpu/ops/depth.py``'s jnp path):
    softmax over dim 1, optional disparity, central moments. Arguments as
    ``depth_regression``."""
    prob = torch.softmax(depth_prob, dim=1)
    if depth_inv:
        depth_values = 1.0 / torch.clamp(depth_values, min=1e-6)
    depth = torch.sum(prob * depth_values, dim=1)
    var = torch.sum(prob * (depth_values - depth[:, None]) ** 2, dim=1)
    std = torch.sqrt(torch.clamp(var, min=1e-10))
    return depth, std


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

    depth_prob (logits), depth_values (B, D, H, W) float32. With
    ``depth_inv`` the plane values are converted to disparity first.
    Returns (depth, std), each (B, H, W), in the pdf's native space;
    differentiable in both inputs."""
    return DepthRegression.apply(depth_prob, depth_values, depth_inv)


def _launch(depth_prob, depth_values, depth_inv):
    global launches
    req = _build.require
    dev = depth_prob.device
    req(dev.type == "cuda", "depth regression kernel needs a CUDA tensor, "
        "got {}", dev)
    req(depth_prob.ndim == 4, "depth_prob must be (B, D, H, W), got {}",
        tuple(depth_prob.shape))
    B, D, H, W = depth_prob.shape
    for name, t in (("depth_prob", depth_prob), ("depth_values", depth_values)):
        req(t.device == dev, "{} is on {}, depth_prob on {}", name, t.device,
            dev)
        req(t.dtype == torch.float32, "{} must be float32, got {}", name,
            t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(tuple(t.shape) == (B, D, H, W), "{} has shape {}, expected {}",
            name, tuple(t.shape), (B, D, H, W))
    req(D > 0, "depth regression needs at least one plane")

    depth = torch.empty(B, H, W, dtype=torch.float32, device=dev)
    std = torch.empty(B, H, W, dtype=torch.float32, device=dev)
    lib = _build.load_library("depth_regression")
    fn = lib.enerf_depth_regression
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    rc = fn(depth_prob.data_ptr(), depth_values.data_ptr(), depth.data_ptr(),
            std.data_ptr(), B, D, H, W, int(depth_inv),
            _build.stream_handle(dev))
    _build.check_rc("depth_regression", rc)
    launches += 1
    return depth, std
