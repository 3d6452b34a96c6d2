"""3D cost-volume regularization U-Nets; counterpart of
``enerf_tpu/models/cost_reg.py`` (``CostRegNet``, ``MinCostRegNet``,
``MinCostRegNetTri``).

Input: the variance volume (B, D, H, W, C) channels-last, read by the
Conv3d stack as an NCDHW view with ``channels_last_3d`` strides (no copy).
Encoder 8→16→32(→64), transposed-conv decoder with skip adds; two heads
with bias=False: ``feat_conv`` (8ch feature volume) and ``depth_conv``
(1ch depth logits). MinCostRegNet drops the deepest stage and serves
cascade level 0.

Returns (feature volume (B, D, H, W, 8) contiguous, depth logits
(B, D, H, W)), both in the compute ``dtype``: in the bf16 mode the convs
run in bf16 and the heads cast their input to it (JAX ``cost_reg.py:
_dual_head``). In float32 under autograd every conv's weight gradient is
the port's kernel's (``models/layers.py:conv_f32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enerf_tpu_torch.models.layers import (
    ConvBnReLU3D,
    ConvTransposeBn,
    conv_f32,
    conv_in,
)


def _heads(x, feat_conv, depth_conv, dtype):
    if dtype == torch.float32:
        feat, logits = conv_f32(feat_conv[0], x), conv_f32(depth_conv[0], x)
    else:
        feat = conv_in(feat_conv[0], x, dtype)
        logits = conv_in(depth_conv[0], x, dtype)
    return feat.permute(0, 2, 3, 4, 1).contiguous(), logits[:, 0].contiguous()


class CostRegNet(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.conv0 = ConvBnReLU3D(in_ch, 8, **kw)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2, **kw)
        self.conv2 = ConvBnReLU3D(16, 16, **kw)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2, **kw)
        self.conv4 = ConvBnReLU3D(32, 32, **kw)
        self.conv5 = ConvBnReLU3D(32, 64, stride=2, **kw)
        self.conv6 = ConvBnReLU3D(64, 64, **kw)
        self.conv7 = ConvTransposeBn(64, 32, **kw)
        self.conv9 = ConvTransposeBn(32, 16, **kw)
        self.conv11 = ConvTransposeBn(16, 8, **kw)
        self.feat_conv = nn.Sequential(nn.Conv3d(8, 8, 3, padding=1, bias=False))
        self.depth_conv = nn.Sequential(nn.Conv3d(8, 1, 3, padding=1, bias=False))

    def forward(self, volume: torch.Tensor):
        conv0 = self.conv0(volume.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return _heads(x, self.feat_conv, self.depth_conv, self.dtype)


class MinCostRegNet(nn.Module):
    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.conv0 = ConvBnReLU3D(in_ch, 8, **kw)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2, **kw)
        self.conv2 = ConvBnReLU3D(16, 16, **kw)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2, **kw)
        self.conv4 = ConvBnReLU3D(32, 32, **kw)
        self.conv9 = ConvTransposeBn(32, 16, **kw)
        self.conv11 = ConvTransposeBn(16, 8, **kw)
        self.feat_conv = nn.Sequential(nn.Conv3d(8, 8, 3, padding=1, bias=False))
        self.depth_conv = nn.Sequential(nn.Conv3d(8, 1, 3, padding=1, bias=False))

    def forward(self, volume: torch.Tensor):
        conv0 = self.conv0(volume.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = conv2 + self.conv9(conv4)
        x = conv0 + self.conv11(x)
        return _heads(x, self.feat_conv, self.depth_conv, self.dtype)


class MinCostRegNetTri(nn.Module):
    """MinCostRegNet with trilinear (align_corners) upsampling and a
    ConvBnReLU3D in place of each transposed-conv stage (reference
    cost_reg_net_.py:52-95; not on the stock forward path)."""

    def __init__(self, in_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.conv0 = ConvBnReLU3D(in_ch, 8, **kw)
        self.conv1 = ConvBnReLU3D(8, 16, stride=2, **kw)
        self.conv2 = ConvBnReLU3D(16, 16, **kw)
        self.conv3 = ConvBnReLU3D(16, 32, stride=2, **kw)
        self.conv4 = ConvBnReLU3D(32, 32, **kw)
        self.conv9 = ConvBnReLU3D(32, 16, **kw)
        self.conv11 = ConvBnReLU3D(16, 8, **kw)
        self.feat_conv = nn.Sequential(nn.Conv3d(8, 8, 3, padding=1, bias=False))
        self.depth_conv = nn.Sequential(nn.Conv3d(8, 1, 3, padding=1, bias=False))

    def forward(self, volume: torch.Tensor):
        def up2(v):
            return F.interpolate(v, scale_factor=2.0, mode="trilinear",
                                 align_corners=True)

        conv0 = self.conv0(volume.permute(0, 4, 1, 2, 3))
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = conv2 + self.conv9(up2(conv4))
        x = conv0 + self.conv11(up2(x))
        return _heads(x, self.feat_conv, self.depth_conv, self.dtype)
