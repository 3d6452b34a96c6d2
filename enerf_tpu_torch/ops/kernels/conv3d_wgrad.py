"""The weight gradient of the 3D CNNs' convolutions: the CUDA kernel
``csrc/conv3d_wgrad.cu``, its wrapper, the autograd Function that the
float32 train step's Conv3d and ConvTranspose3d run through, and its plain
PyTorch version.

Replaces no TPU kernel (the JAX package leaves these gradients to XLA).
cuDNN's float32 weight gradient of these convs, with TF32 off, runs a
grouped-direct kernel at about 1 % of the card's f32 rate, in either
memory format; the kernel is a split-K implicit GEMM over the output
voxels (its source says how).

``conv3d(conv, x)`` is ``conv(x)`` for a ``nn.Conv3d`` or
``nn.ConvTranspose3d`` that ``takes``: the forward and the input gradient
are cuDNN's as before, the weight gradient is the kernel's on a CUDA
tensor and the plain version's (``torch.ops.aten.convolution_backward``,
what autograd computes for the module) on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from enerf_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (set to 0 to reset): one
# a weight gradient, i.e. a conv of the 3D CNNs a train step.
launches = 0

THREADS = 256               # a block of pass 1 (``kThreads``)
TAPS = 27
# Pass 1's blocks a streaming multiprocessor should get: more split the
# voxels finer (and lengthen pass 2's sum), fewer leave SMs idle.
BLOCKS_PER_SM = 4
# enerf_conv3d_wgrad(x, gy, ws, dw, N, Ci, D, H, W, Co, Do, Ho, Wo, stride,
# pad, tm, rows_per_block, splits, tiles_per_block, groups, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def takes(conv: nn.Module) -> bool:
    """Whether ``conv`` is a conv the kernel computes the weight gradient
    of: a Conv3d or ConvTranspose3d with a 3x3x3 kernel, no bias, one
    group, no dilation, padding 1 and stride 1 or 2 (every conv of the 3D
    CNNs), whose input channels (the output channels of a transposed conv)
    are a multiple of 4."""
    if not isinstance(conv, (nn.Conv3d, nn.ConvTranspose3d)):
        return False
    ci = (conv.out_channels if isinstance(conv, nn.ConvTranspose3d)
          else conv.in_channels)
    return (conv.kernel_size == (3, 3, 3) and conv.bias is None
            and conv.groups == 1 and conv.dilation == (1, 1, 1)
            and conv.padding == (1, 1, 1)
            and conv.stride in ((1, 1, 1), (2, 2, 2)) and ci % 4 == 0)


def conv3d(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` (``takes(conv)``), its weight gradient by the kernel on
    a CUDA tensor."""
    transposed = isinstance(conv, nn.ConvTranspose3d)
    return Conv3d.apply(x, conv.weight, conv.stride[0], transposed,
                        conv.output_padding if transposed else (0, 0, 0))


class Conv3d(torch.autograd.Function):
    """cuDNN's forward and input gradient; the weight gradient by
    ``wgrad`` on a CUDA tensor, by the plain version on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, weight, stride: int, transposed: bool,
                output_padding):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, transposed, output_padding)
        if transposed:
            return F.conv_transpose3d(x, weight, None, stride, 1,
                                      output_padding)
        return F.conv3d(x, weight, None, stride, 1)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, transposed, output_padding = ctx.geometry
        need_x, need_w = ctx.needs_input_grad[:2]
        kernel_w = need_w and gy.device.type == "cuda"
        gx = gw = None
        if need_x or (need_w and not kernel_w):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, weight, None, (stride,) * 3, (1, 1, 1), (1, 1, 1),
                transposed, output_padding, 1,
                [need_x, need_w and not kernel_w, False])
        if kernel_w:
            # a transposed conv's weight gradient is a conv's with its
            # input and output gradient in each other's place
            gw = wgrad(gy, x, stride) if transposed else wgrad(x, gy, stride)
        return gx, gw, None, None, None


def wgrad_plain(x: torch.Tensor, gy: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain version of ``wgrad``: the weight gradient of
    ``F.conv3d(x, w, stride=stride, padding=1)`` for the output gradient
    ``gy``, by ``torch.ops.aten.convolution_backward``."""
    Co, Ci = gy.shape[1], x.shape[1]
    w = x.new_empty(Co, Ci, 3, 3, 3)
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, (stride,) * 3, (1, 1, 1), (1, 1, 1), False,
        (0, 0, 0), 1, [False, True, False])[1]


def wgrad(x: torch.Tensor, gy: torch.Tensor, stride: int) -> torch.Tensor:
    """The weight gradient (Co, Ci, 3, 3, 3) of a conv of stride
    ``stride`` and padding 1 whose input is ``x`` (N, Ci, D, H, W) and
    whose output gradient is ``gy`` (N, Co, Do, Ho, Wo), both float32. The
    kernel on a CUDA tensor (any other type raises ``ValueError``), the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return wgrad_plain(x, gy, stride)
    return _launch(x, gy, stride)


def plan(Co: int, Ci: int, rows: int, sms: int
         ) -> Tuple[int, int, int, int, int]:
    """Pass 1's launch plan: (tm, tiles a block, tile groups, rows a
    block, splits). A thread tile is ``tm`` output channels (8 where 8
    divides Co, as in every conv of the 3D CNNs but the depth head, else
    1) by 4 input channels of one tap; a block holds up to ``THREADS``
    tiles (the rest of its threads replicate them), so a conv of more
    tiles spreads them over ``groups`` blocks.
    The ``rows`` output rows (n, od, oh) are split over ``splits`` blocks
    of ``rows a block`` rows, so that about ``BLOCKS_PER_SM`` blocks fall
    to each of the ``sms`` multiprocessors."""
    tm = 8 if Co % 8 == 0 else 1
    tiles = Co // tm * TAPS * (Ci // 4)
    per_block = min(tiles, THREADS)
    groups = -(-tiles // per_block)
    want = max(1, -(-BLOCKS_PER_SM * sms // groups))
    rows_per_block = -(-rows // min(rows, want))
    return tm, per_block, groups, rows_per_block, -(-rows // rows_per_block)


def _launch(x: torch.Tensor, gy: torch.Tensor, stride: int) -> torch.Tensor:
    global launches
    req = _build.require
    dev = x.device
    req(dev.type == "cuda", "conv3d weight-gradient kernel needs a CUDA "
        "tensor, got {}", dev)
    req(gy.device == dev, "gy is on {}, x on {}", gy.device, dev)
    req(x.dtype == gy.dtype == torch.float32, "conv3d weight-gradient "
        "kernel takes float32, got x {} and gy {}", x.dtype, gy.dtype)
    req(x.ndim == 5 and gy.ndim == 5, "x and gy must be (N, C, D, H, W), "
        "got {} and {}", tuple(x.shape), tuple(gy.shape))
    req(stride in (1, 2), "stride must be 1 or 2, got {}", stride)
    N, Ci, D, H, W = x.shape
    _, Co, Do, Ho, Wo = gy.shape
    req(gy.shape[0] == N, "x has {} samples, gy {}", N, gy.shape[0])
    req(Ci % 4 == 0, "input channels must be a multiple of 4, got {}", Ci)
    req(N * Do * Ho * Wo > 0, "gy has no voxels: {}", tuple(gy.shape))
    for name, n_in, n_out in (("D", D, Do), ("H", H, Ho), ("W", W, Wo)):
        req(n_out == (n_in - 1) // stride + 1, "{}: output {} for input {} "
            "at stride {}", name, n_out, n_in, stride)
    # the channels-last storage, 16-byte aligned for the float4 reads
    x, gy = (t.clone(memory_format=torch.channels_last_3d)
             if t.data_ptr() % 16 else
             t.contiguous(memory_format=torch.channels_last_3d)
             for t in (x, gy))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tm, per_block, groups, rows_per_block, splits = plan(Co, Ci, N * Do * Ho,
                                                         sms)
    ws = torch.empty(splits * Co * TAPS * Ci, dtype=torch.float32, device=dev)
    dw = torch.empty(Co, Ci, 3, 3, 3, dtype=torch.float32, device=dev)
    fn = _build.load_function("conv3d_wgrad", "enerf_conv3d_wgrad", _ARGTYPES)
    rc = fn(x.data_ptr(), gy.data_ptr(), ws.data_ptr(), dw.data_ptr(), N, Ci,
            D, H, W, Co, Do, Ho, Wo, stride, 1, tm, rows_per_block, splits,
            per_block, groups, _build.stream_handle(dev))
    _build.check_rc("conv3d_wgrad", rc)
    launches += 1
    return dw

