"""ResUnet feature extractor; counterpart of ``enerf_tpu/models/res_unet.py``
(reference lib/networks/enerf/res_unet.py:4-99; not on the stock forward
path). A 32-channel feature map at 1/4 resolution, channels-last.

Its upsampling stage ``up1`` is flax's own ``nn.ConvTranspose`` in the JAX
package (no kernel flip), carried into ``nn.ConvTranspose2d`` by
``utils/convert.py`` with the kernel flipped in space.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from enerf_tpu_torch.models.layers import conv_bias


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype
        ) -> torch.Tensor:
    """BN in float32, its output in ``dtype`` (flax's BatchNorm with a
    dtype)."""
    return bn(x.float()).to(dtype)


class ResidualConv(nn.Module):
    """bn → relu → conv → bn → relu → conv, plus a 3x3 conv skip
    (reference res_unet.py:4-24). NCHW in and out."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn0 = nn.BatchNorm2d(in_ch)
        self.conv0 = nn.Conv2d(in_ch, out_ch, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.skip = nn.Conv2d(in_ch, out_ch, 3, stride, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = conv_bias(self.conv0, torch.relu(_bn(self.bn0, x, dt)), dt)
        h = conv_bias(self.conv1, torch.relu(_bn(self.bn1, h, dt)), dt)
        return h + conv_bias(self.skip, x, dt)


class ResUnet(nn.Module):
    def __init__(self, in_ch: int = 3,
                 filters: Sequence[int] = (16, 32, 64, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = filters
        self.dtype = dtype
        self.in_conv0 = nn.Conv2d(in_ch, f[0], 3, padding=1)
        self.in_bn = nn.BatchNorm2d(f[0])
        self.in_conv1 = nn.Conv2d(f[0], f[0], 3, padding=1)
        self.in_skip = nn.Conv2d(in_ch, f[0], 3, padding=1)
        self.res1 = ResidualConv(f[0], f[1], 2, dtype)
        self.res2 = ResidualConv(f[1], f[2], 2, dtype)
        self.bridge = ResidualConv(f[2], f[3], 2, dtype)
        # reference res_unet.py:27-37: ConvTranspose k2 s2
        self.up1 = nn.ConvTranspose2d(f[3], f[3], 2, stride=2)
        self.out = nn.Conv2d(f[3] + f[2], 32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C) -> (N, H/4, W/4, 32) contiguous."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        inp = conv_bias(self.in_conv0, x, dt)
        inp = torch.relu(_bn(self.in_bn, inp, dt))
        x1 = conv_bias(self.in_conv1, inp, dt) + conv_bias(self.in_skip, x, dt)
        x3 = self.res2(self.res1(x1))
        x4 = conv_bias(self.up1, self.bridge(x3), dt)
        out = conv_bias(self.out, torch.cat([x4, x3], dim=1), dt)
        return out.permute(0, 2, 3, 1).contiguous()
