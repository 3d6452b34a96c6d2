"""2D FPN feature extractor and the CNNRender refinement head;
counterpart of ``enerf_tpu/models/feature_net.py``.

conv0 8ch@1x → conv1 16ch@1/2 → conv2 32ch@1/4; 1x1 laterals to 32ch;
top-down upsample-add (bilinear, align_corners); smooth convs. Takes and
returns channels-last (NHWC) tensors; the convs run on NCHW views with
channels-last strides, so the layout change costs no copy.

In a compute ``dtype`` other than float32 (the bf16 mode) every conv runs
in it and the three outputs are in it (JAX ``feature_net.py:27-62``).
"""

from __future__ import annotations

import torch
from torch import nn

from enerf_tpu_torch.models.layers import ConvBnReLU, conv_bias
from enerf_tpu_torch.ops.sampling import resize_bilinear_nchw


def _upsample_add(x, y):
    return resize_bilinear_nchw(x, y.shape[-2:]) + y


class FeatureNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.conv0 = nn.Sequential(ConvBnReLU(3, 8, 3, 1, 1, **kw),
                                   ConvBnReLU(8, 8, 3, 1, 1, **kw))
        self.conv1 = nn.Sequential(ConvBnReLU(8, 16, 5, 2, 2, **kw),
                                   ConvBnReLU(16, 16, 3, 1, 1, **kw))
        self.conv2 = nn.Sequential(ConvBnReLU(16, 32, 5, 2, 2, **kw),
                                   ConvBnReLU(32, 32, 3, 1, 1, **kw))
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
        dt = self.dtype
        feat2 = conv_bias(self.toplayer, conv2, dt)
        feat1 = _upsample_add(feat2, conv_bias(self.lat1, conv1, dt))
        feat0 = _upsample_add(feat1, conv_bias(self.lat0, conv0, dt))
        feat1 = conv_bias(self.smooth1, feat1, dt)
        feat0 = conv_bias(self.smooth0, feat0, dt)
        return tuple(f.permute(0, 2, 3, 1).contiguous()
                     for f in (feat2, feat1, feat0))


class CNNRender(nn.Module):
    """Residual 2D refinement of a rendered image (reference
    feature_net.py:38-54; not on the stock forward path): conv0 8ch@1x,
    conv1 16ch@1/2, upsample-add of a 1x1 lateral of conv0, a 1x1 conv to
    rgb, added to the input and clipped to [0, 1]."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvBnReLU(3, 8, 3, 1, 1, dtype=dtype)
        self.conv1 = ConvBnReLU(8, 16, 5, 2, 2, dtype=dtype)
        self.conv2 = nn.Conv2d(8, 16, 1)
        self.conv3 = nn.Conv2d(16, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) -> (N, H, W, 3) contiguous."""
        x = x.permute(0, 3, 1, 2)
        conv0 = self.conv0(x)
        conv2 = _upsample_add(self.conv1(conv0),
                              conv_bias(self.conv2, conv0, self.dtype))
        out = conv_bias(self.conv3, conv2, self.dtype) + x
        return torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1).contiguous()
