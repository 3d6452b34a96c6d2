"""Building-block layers; counterpart of ``enerf_tpu/models/layers.py``.

Module and parameter names follow the reference state dict
(``conv``/``bn`` inside ConvBnReLU, ``.0``/``.1`` inside the ConvTranspose
decoder stages, ``.0`` for the Linear of a Linear+ReLU), so a reference
``.pth`` loads as it is. BN has eps 1e-5 and uses its running statistics
in eval mode. ConvTranspose3d is kernel 3, stride 2, padding 1,
output_padding 1: it exactly doubles each spatial dim.

The conv blocks take a compute ``dtype`` (``conv_bn``): float32, or the
bf16 mode of ``compute_dtype: bfloat16``, which casts the computation and
never the parameters or the BN statistics. In float32, a conv whose weight
gradient autograd records takes it from the port's kernel where the
kernel computes it (``conv_f32``).

``convert_sync_bn`` turns every BN of a model into the synced BN of a
data-parallel run (``SyncBatchNorm2d`` / ``SyncBatchNorm3d``), whose
training-mode statistics are those of the global batch over all ranks, as
the JAX package's step computes them on the global batch
(``enerf_tpu/train/step.py:32-90``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from enerf_tpu_torch.ops.kernels import conv3d_wgrad
from enerf_tpu_torch.parallel.dist import world_size


def conv_in(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv`` (a Conv2d, Conv3d, ConvTranspose2d or ConvTranspose3d) on
    ``x`` with its weight (or ``weight``, in its layout) cast to ``dtype``
    and the input cast to ``dtype``, without its bias: the output is in
    ``dtype``."""
    w = (conv.weight if weight is None else weight).to(dtype)
    x = x.to(dtype)
    if isinstance(conv, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        fn = (F.conv_transpose2d if isinstance(conv, nn.ConvTranspose2d)
              else F.conv_transpose3d)
        return fn(x, w, None, conv.stride, conv.padding, conv.output_padding,
                  conv.groups, conv.dilation)
    return conv._conv_forward(x, w, None)


def conv_f32(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` in float32. Where autograd records the conv's weight
    gradient (grad mode on, the weight requiring one) and the conv is one
    the weight-gradient kernel takes (``conv3d_wgrad.takes``: every Conv3d
    and ConvTranspose3d of the 3D CNNs), through
    ``conv3d_wgrad.conv3d``: the same forward and input gradient, the
    weight gradient by the kernel on a CUDA tensor. cuDNN's own float32
    weight gradient of these convs runs a grouped-direct kernel far below
    the card's rate. Eval, ``no_grad`` and ``inference_mode`` calls run
    the module's forward."""
    if (torch.is_grad_enabled() and conv.weight.requires_grad
            and conv3d_wgrad.takes(conv)):
        return conv3d_wgrad.conv3d(conv, x)
    return conv(x)


def conv_bias(conv: nn.Module, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """A conv with a bias in ``dtype``: the conv rounds to ``dtype``, then
    the bias is added in ``dtype``, as flax's ``nn.Conv(dtype=...)`` does.
    In float32, the module's own forward."""
    if dtype == torch.float32:
        return conv(x)
    y = conv_in(conv, x, dtype)
    return y + conv.bias.to(dtype).view((1, -1) + (1,) * (y.dim() - 2))


def fold_bn(conv: nn.Module, bn: nn.modules.batchnorm._BatchNorm
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN folded into ``conv``: (weight · s, b) in float32, with
    s = γ / sqrt(running var + eps) on the output channels and b = β −
    running mean · s (``enerf_tpu/models/layers.py:_bn_fold``)."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * inv
    out_dim = 1 if isinstance(conv, nn.ConvTranspose3d) else 0
    shape = [1] * conv.weight.dim()
    shape[out_dim] = -1
    return conv.weight.float() * inv.view(shape), bias


def conv_bn(conv: nn.Module, bn: nn.modules.batchnorm._BatchNorm,
            x: torch.Tensor, dtype: torch.dtype, relu: bool) -> torch.Tensor:
    """conv → BN (→ ReLU) in the compute type ``dtype``, rounding where the
    JAX package's layers round (``enerf_tpu/models/layers.py:98-228``).

    float32: the modules' own forwards, the conv through ``conv_f32``.
    Any other type, in training: the conv in ``dtype``, then BN (batch
    statistics, running statistics updated, the synced BN's merge
    included) and ReLU in float32, as flax's BN built without a dtype
    computes. In eval: BN folded into the conv in float32 (``fold_bn``),
    the folded weight and the bias cast to ``dtype``, the conv, bias add
    and ReLU in ``dtype``."""
    if dtype == torch.float32:
        y = bn(conv_f32(conv, x))
    elif bn.training:
        y = bn(conv_in(conv, x, dtype).float())
    else:
        w, b = _folded(conv, bn, dtype)
        y = conv_in(conv, x, dtype, weight=w)
        y = y + b.view((1, -1) + (1,) * (y.dim() - 2))
    return torch.relu(y) if relu else y


def _folded(conv: nn.Module, bn: nn.modules.batchnorm._BatchNorm,
            dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_bn`` cast to ``dtype``. Where no gradient is recorded it is
    kept on ``bn`` and made again only when a weight or statistic has
    changed: a new tensor, or an in-place write (an optimizer step,
    ``load_state_dict``) that moves its version counter."""
    if torch.is_grad_enabled():
        w, b = fold_bn(conv, bn)
        return w.to(dtype), b.to(dtype)
    ts = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    key = (dtype, tuple((t.data_ptr(), t._version) for t in ts))
    cached = getattr(bn, "_fold_cache", None)
    if cached is None or cached[0] != key:
        with torch.inference_mode(False):
            w, b = fold_bn(conv, bn)
            cached = bn._fold_cache = (key, (w.to(dtype), b.to(dtype)))
    return cached[1]


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BN + ReLU, computing in ``dtype``
    (``conv_bn``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return conv_bn(self.conv, self.bn, x, self.dtype, relu=True)


class ConvBnReLU3D(nn.Module):
    """Conv3d(bias=False) + BN + ReLU, computing in ``dtype``
    (``conv_bn``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-5)

    def forward(self, x):
        return conv_bn(self.conv, self.bn, x, self.dtype, relu=True)


class ConvTransposeBn(nn.Sequential):
    """ConvTranspose3d(k3, s2, p1, output_padding 1, bias=False) + BN:
    the U-Net decoder stage, computing in ``dtype`` (``conv_bn``)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm3d(out_ch, eps=1e-5))
        self.dtype = dtype

    def forward(self, x):
        return conv_bn(self[0], self[1], x, self.dtype, relu=False)


class _SyncBatchNormFn(torch.autograd.Function):
    """Training-mode BN over the global batch of all ranks.

    Forward: each rank's per-channel (count, mean, M2) go to every rank by
    one ``all_reduce`` of a zero-filled (world, 3, C) buffer in which each
    rank fills its own row (a sum with zeros is exact), and are merged by
    Chan's parallel rule (mean = μ_0 + Σ n_r (μ_r − μ_0) / n, M2 = Σ M2_r +
    Σ n_r (μ_r − μ)²), not from Σx and Σx², which cancel badly in f32. The output is
    normalized by the global mean and biased variance; the running
    statistics move by ``momentum`` toward the global mean and unbiased
    variance M2 / (n − 1), n the global count.

    Backward: one ``all_reduce`` of the per-channel [Σdy, Σdy·x̂], so that
    dx = γ·invstd·(dy − Σdy/n − x̂·Σdy·x̂/n) is the gradient of the sum of
    the ranks' losses, and the parameters get this rank's Σdy·x̂ and Σdy:
    DDP's mean over the ranks then gives the gradient of the mean of the
    ranks' losses, as torch's own SyncBatchNorm does."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum):
        C = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, C) + (1,) * (x.dim() - 2)
        count = x.numel() // C
        # this rank's mean, refined by the mean of the deviations from it
        # (one f32 sum rounds at the scale of the sum), and its M2
        mean_r = x.mean(dims)
        dev = x - mean_r.view(shape)
        corr = dev.mean(dims)
        m2_r = torch.sum(dev * dev, dims) - count * corr * corr
        stats = x.new_zeros(dist.get_world_size(), 3, C)
        stats[dist.get_rank()] = torch.stack(
            [torch.full_like(mean_r, count), mean_r + corr, m2_r])
        dist.all_reduce(stats)
        counts, means, m2s = stats.unbind(1)           # (world, C) each
        n = counts.sum(0)
        # rank 0's mean plus the count-weighted deltas: Σ n_r μ_r would
        # round at the scale of n·μ
        mean = means[0] + (counts * (means - means[0])).sum(0) / n
        m2 = m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)
        invstd = torch.rsqrt(m2 / n + eps)
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(m2 / (n - 1), alpha=momentum)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return ((x - mean.view(shape)) * (weight * invstd).view(shape)
                + bias.view(shape))

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, C) + (1,) * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        both = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(both)
        g_dy, g_dy_xhat = (both[:C] / n).view(shape), (both[C:] / n).view(shape)
        dx = (weight * invstd).view(shape) * (dy - g_dy - xhat * g_dy_xhat)
        return dx, sum_dy_xhat, sum_dy, None, None, None, None


class _SyncBatchNorm:
    """Training-mode statistics over the global batch of every rank when
    a process group of more than one rank exists (``_SyncBatchNormFn``);
    otherwise, and in eval mode, the plain ``nn.BatchNorm`` forward, with
    no collective. For the port's BNs: affine, with running statistics
    and a momentum."""

    def forward(self, x):
        if not (self.training and world_size() > 1):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        return _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                      self.running_mean, self.running_var,
                                      self.eps, self.momentum)


class SyncBatchNorm2d(_SyncBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its state-dict keys) with global-batch
    statistics in a data-parallel run."""


class SyncBatchNorm3d(_SyncBatchNorm, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (its state-dict keys) with global-batch
    statistics in a data-parallel run."""


_SYNCED = {nn.BatchNorm2d: SyncBatchNorm2d, nn.BatchNorm3d: SyncBatchNorm3d}


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` / ``nn.BatchNorm3d`` of ``model`` its
    synced subclass, in place: each module keeps its identity, parameters
    and buffers (an optimizer made before still holds them). Returns
    ``model``."""
    for m in model.modules():
        if type(m) in _SYNCED:
            m.__class__ = _SYNCED[type(m)]
    return model


class LinearReLU(nn.Sequential):
    """Linear + ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.Linear(in_ch, out_ch), nn.ReLU())


def init_weights(module: nn.Module, generator: Optional[torch.Generator],
                 kaiming_linear: bool = False) -> None:
    """Initialize every conv / linear / BN of ``module`` from ``generator``.

    Convs take torch's default (uniform ±1/sqrt(fan_in), bias likewise);
    Linears take kaiming-normal weights and zero bias when
    ``kaiming_linear`` (the NeRF heads), else torch's default; BN starts at
    scale 1, bias 0, running mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            fan_in = m.weight[0].numel() if not isinstance(
                m, nn.ConvTranspose3d) else m.weight.shape[0] * math.prod(
                    m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.Linear):
            if kaiming_linear:
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
                nn.init.zeros_(m.bias)
            else:
                bound = 1.0 / math.sqrt(m.in_features)
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
