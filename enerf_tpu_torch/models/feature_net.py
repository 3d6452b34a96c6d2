"""2D FPN feature extractor; counterpart of
``enerf_tpu/models/feature_net.py``.

conv0 8ch@1x → conv1 16ch@1/2 → conv2 32ch@1/4; 1x1 laterals to 32ch;
top-down upsample-add (bilinear, align_corners); smooth convs. Takes and
returns channels-last (NHWC) tensors; the convs run on NCHW views with
channels-last strides, so the layout change costs no copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enerf_tpu_torch.models.layers import ConvBnReLU


def _upsample_add(x, y):
    return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                         align_corners=True) + y


class FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8, 3, 1, 1),
                                   ConvBnReLU(8, 8, 3, 1, 1))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2, 2),
                                   ConvBnReLU(16, 16, 3, 1, 1))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2, 2),
                                   ConvBnReLU(32, 32, 3, 1, 1))
        self.toplayer = nn.Conv2d(32, 32, 1)
        self.lat1 = nn.Conv2d(16, 32, 1)
        self.lat0 = nn.Conv2d(8, 32, 1)
        self.smooth1 = nn.Conv2d(32, 16, 3, padding=1)
        self.smooth0 = nn.Conv2d(32, 8, 3, padding=1)

    def forward(self, x: torch.Tensor):
        """x (N, H, W, 3) → (feat2 32ch @1/4, feat1 16ch @1/2, feat0 8ch
        @1), each (N, h, w, c) contiguous."""
        x = x.permute(0, 3, 1, 2)
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        feat2 = self.toplayer(conv2)
        feat1 = _upsample_add(feat2, self.lat1(conv1))
        feat0 = _upsample_add(feat1, self.lat0(conv0))
        feat1 = self.smooth1(feat1)
        feat0 = self.smooth0(feat0)
        return tuple(f.permute(0, 2, 3, 1).contiguous()
                     for f in (feat2, feat1, feat0))
