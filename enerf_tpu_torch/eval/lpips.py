"""LPIPS (VGG) in PyTorch; counterpart of ``enerf_tpu/eval/lpips_jax.py``
(the reference uses the ``lpips`` pip package with net='vgg',
lib/evaluators/enerf.py:25).

Architecture: scale inputs by LPIPS's shift/scale constants, run the five
VGG16 feature stages (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3),
unit-normalize along channels, apply the learned 1×1 ``lin`` weights,
average spatially, sum over stages.

Weights load from the same ``data/lpips_vgg.npz`` as the JAX package
(torchvision vgg16 ``features.{i}.weight`` / ``.bias`` in torch's (out, in,
kh, kw) layout, and lpips' ``lin{i}.model.1.weight``). Without the file,
LPIPS is unavailable: the evaluators report none and print
``lpips_skip_notice``'s line.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_WEIGHTS = "data/lpips_vgg.npz"

# vgg16.features conv layer indices per LPIPS stage
STAGES = (
    (0, 2),
    (5, 7),
    (10, 12, 14),
    (17, 19, 21),
    (24, 26, 28),
)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_skip_notice() -> None:
    """Loud degradation notice: the reference evaluator always reports
    LPIPS (lib/evaluators/enerf.py:71-87); a silently missing weights
    file must never make a metric table look complete."""
    print(f"LPIPS=skipped (weights missing: {DEFAULT_WEIGHTS} — export "
          "with eval/lpips_jax.py on a machine with the `lpips` package)")


class LPIPS(nn.Module):
    """LPIPS-VGG over (B, H, W, 3) images in [-1, 1]; returns (B,)."""

    def __init__(self, raw: Mapping[str, np.ndarray]):
        super().__init__()
        self.convs = nn.ParameterDict()
        for stage in STAGES:
            for idx in stage:
                self.convs[f"w{idx}"] = nn.Parameter(torch.from_numpy(
                    np.asarray(raw[f"features.{idx}.weight"], np.float32)),
                    requires_grad=False)
                self.convs[f"b{idx}"] = nn.Parameter(torch.from_numpy(
                    np.asarray(raw[f"features.{idx}.bias"], np.float32)),
                    requires_grad=False)
        for i in range(len(STAGES)):
            # (1, C, 1, 1) torch conv weights
            lin = np.asarray(raw[f"lin{i}.model.1.weight"], np.float32)
            self.register_buffer(f"lin{i}", torch.from_numpy(
                np.ascontiguousarray(lin[0, :, 0, 0])).view(1, -1, 1, 1))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def _stages(self, x):
        outs = []
        for si, stage in enumerate(STAGES):
            if si > 0:
                x = F.max_pool2d(x, 2, 2)
            for idx in stage:
                x = F.relu(F.conv2d(x, self.convs[f"w{idx}"],
                                    self.convs[f"b{idx}"], padding=1))
            outs.append(x)
        return outs

    def forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """pred, gt: (B, H, W, 3) in [-1, 1] (the LPIPS convention; the
        evaluators map [0, 1] to it, as the reference does, enerf.py:85)."""
        xs = (pred.permute(0, 3, 1, 2) - self.shift) / self.scale
        ys = (gt.permute(0, 3, 1, 2) - self.shift) / self.scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self._stages(xs), self._stages(ys))):
            na = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            total = total + torch.mean(
                torch.sum(d * getattr(self, f"lin{i}"), dim=1), dim=(1, 2))
        return total


def write_seeded_weights(path: str, seed: int) -> None:
    """Seeded random LPIPS weights in the layout of ``data/lpips_vgg.npz``,
    for tests and the smoke run where the real file is absent:
    torchvision's vgg16 ``features.{i}.weight`` (out, in, 3, 3) and
    ``.bias`` (He-scaled normal, biases 0.05 N(0, 1)), lpips'
    ``lin{i}.model.1.weight`` (1, C, 1, 1) (0.1 |N(0, 1)|)."""
    rng = np.random.RandomState(seed)
    raw, idx, cin = {}, 0, 3
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512):
        if c == "M":
            idx += 1
            continue
        raw[f"features.{idx}.weight"] = (rng.randn(c, cin, 3, 3)
                                         * np.sqrt(2.0 / (cin * 9))
                                         ).astype(np.float32)
        raw[f"features.{idx}.bias"] = (0.05 * rng.randn(c)).astype(np.float32)
        idx, cin = idx + 2, c
    for i, c in enumerate((64, 128, 256, 512, 512)):
        raw[f"lin{i}.model.1.weight"] = (0.1 * np.abs(rng.randn(1, c, 1, 1))
                                         ).astype(np.float32)
    np.savez(path, **raw)


def load_lpips(path: str = DEFAULT_WEIGHTS, device=None) -> Optional[LPIPS]:
    """The LPIPS network of the weights at ``path`` on ``device`` (default
    the GPU, as every entry point of the port), or None when the file is
    absent."""
    if not os.path.exists(path):
        return None
    from enerf_tpu_torch import resolve_device

    with np.load(path) as raw:
        net = LPIPS(dict(raw))
    return net.eval().to(resolve_device(device))


class LPIPSMetric:
    """An evaluator's LPIPS: ``score(gt, pred)`` of two (H, W, 3) images in
    [0, 1], or None when no weights were found."""

    def __init__(self, enabled: bool, path: str = DEFAULT_WEIGHTS,
                 device=None):
        self.net = load_lpips(path, device) if enabled else None

    @torch.inference_mode()
    def score(self, gt: np.ndarray, pred: np.ndarray) -> Optional[float]:
        if self.net is None:
            return None
        dev = self.net.lin0.device

        def prep(img):
            t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
            return t[None].to(dev) * 2.0 - 1.0

        return float(self.net(prep(pred), prep(gt))[0])
