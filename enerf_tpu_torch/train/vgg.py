"""VGG16 perceptual loss; counterpart of ``enerf_tpu/train/vgg.py``
(reference ``lib/train/losses/vgg_perceptual_loss.py``).

The four frozen feature blocks of torchvision's ``vgg16().features``
(layers [:4], [4:9], [9:16], [16:23]), ImageNet normalization, and the L1
distance summed over the blocks. torchvision is not a dependency: the
weights load from an npz of ``features.N.weight`` / ``features.N.bias``
arrays in torchvision's layout (the file ``load_vgg16_params`` of the JAX
package reads); without the file the perceptual term is off.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# vgg16.features conv layers: (out_ch, torchvision layer index) per block
_BLOCK_DEFS = (
    ((64, 0), (64, 2)),                    # features[:4]   (block ends pre-pool)
    ((128, 5), (128, 7)),                  # features[4:9]  (starts with pool)
    ((256, 10), (256, 12), (256, 14)),     # features[9:16]
    ((512, 17), (512, 19), (512, 21)),     # features[16:23]
)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

DEFAULT_WEIGHTS = "data/vgg16_features.npz"


class VGG16Blocks(nn.Module):
    """The convs of the four blocks, named as torchvision's ``features``
    (so the npz's keys are the state dict's). Frozen, eval mode."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        in_ch = 3
        for block in _BLOCK_DEFS:
            for out_ch, idx in block:
                self.features[str(idx)] = nn.Conv2d(in_ch, out_ch, 3, padding=1)
                in_ch = out_ch
        self.register_buffer("mean", torch.tensor(_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).reshape(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) in [0, 1]. Returns the four block outputs, NCHW."""
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        feats = []
        for bi, block in enumerate(_BLOCK_DEFS):
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
            for _, idx in block:
                x = torch.relu(self.features[str(idx)](x))
            feats.append(x)
        return feats


def load_vgg16_params(path: str = DEFAULT_WEIGHTS,
                      device=None) -> Optional[VGG16Blocks]:
    """The VGG16 blocks with the npz's weights on ``device`` (default: the
    GPU), or None when the file is absent."""
    from enerf_tpu_torch import resolve_device

    if not os.path.exists(path):
        return None
    with np.load(path) as raw:
        sd = {k: torch.from_numpy(np.asarray(raw[k], np.float32))
              for k in VGG16Blocks().state_dict()}
    vgg = VGG16Blocks()
    vgg.load_state_dict(sd)
    return vgg.to(resolve_device(device))


def vgg_perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                        vgg: VGG16Blocks) -> torch.Tensor:
    """Σ over the four blocks of mean |f(pred) − f(target)|; pred, target
    (B, H, W, 3) in [0, 1]."""
    loss = pred.new_zeros(())
    for a, b in zip(vgg(pred), vgg(target)):
        loss = loss + torch.mean(torch.abs(a - b))
    return loss
