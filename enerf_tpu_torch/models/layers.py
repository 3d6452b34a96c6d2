"""Building-block layers; counterpart of ``enerf_tpu/models/layers.py``.

Module and parameter names follow the reference state dict
(``conv``/``bn`` inside ConvBnReLU, ``.0``/``.1`` inside the ConvTranspose
decoder stages, ``.0`` for the Linear of a Linear+ReLU), so a reference
``.pth`` loads as it is. BN has eps 1e-5 and uses its running statistics
in eval mode. ConvTranspose3d is kernel 3, stride 2, padding 1,
output_padding 1: it exactly doubles each spatial dim.

``convert_sync_bn`` turns every BN of a model into the synced BN of a
data-parallel run (``SyncBatchNorm2d`` / ``SyncBatchNorm3d``), whose
training-mode statistics are those of the global batch over all ranks, as
the JAX package's step computes them on the global batch
(``enerf_tpu/train/step.py:32-90``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from enerf_tpu_torch.parallel.dist import world_size


class ConvBnReLU(nn.Module):
    """Conv2d(bias=False) + BN + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ConvBnReLU3D(nn.Module):
    """Conv3d(bias=False) + BN + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel, stride=stride,
                              padding=pad, bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-5)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ConvTransposeBn(nn.Sequential):
    """ConvTranspose3d(k3, s2, p1, output_padding 1, bias=False) + BN:
    the U-Net decoder stage."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(
            nn.ConvTranspose3d(in_ch, out_ch, 3, stride=2, padding=1,
                               output_padding=1, bias=False),
            nn.BatchNorm3d(out_ch, eps=1e-5))


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
