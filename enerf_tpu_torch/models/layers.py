"""Building-block layers; counterpart of ``enerf_tpu/models/layers.py``.

Module and parameter names follow the reference state dict
(``conv``/``bn`` inside ConvBnReLU, ``.0``/``.1`` inside the ConvTranspose
decoder stages, ``.0`` for the Linear of a Linear+ReLU), so a reference
``.pth`` loads as it is. BN has eps 1e-5 and uses its running statistics
in eval mode. ConvTranspose3d is kernel 3, stride 2, padding 1,
output_padding 1: it exactly doubles each spatial dim.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


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
