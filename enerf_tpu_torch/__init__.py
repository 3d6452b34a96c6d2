"""PyTorch / CUDA port of ENeRF-TPU, held against the JAX package
``enerf_tpu`` (which it never imports).

Entry points::

    model = enerf_tpu_torch.build_model(cfg)            # on the GPU
    out = enerf_tpu_torch.render(model, batch)          # numpy or tensor batch

    from enerf_tpu_torch.train import create_train_state, make_train_step
    model = enerf_tpu_torch.build_model(cfg, train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, (H, W))
    state, stats = step(state, batch)                   # one optimizer step

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every CUDA kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from enerf_tpu_torch.config import Config, ENeRFConfig
from enerf_tpu_torch.models.enerf import ENeRF


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU. Raises when a CUDA
    device is asked for (or implied) and none is available — the port never
    drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "enerf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def build_model(cfg, device=None, seed: int = 0, train: bool = False) -> ENeRF:
    """The ENeRF network for ``cfg`` (a ``Config`` or its ``ENeRFConfig``),
    weights initialized from ``seed``, on ``device`` (default: the GPU), in
    eval mode, or in training mode when ``train``."""
    dev = resolve_device(device)
    enerf_cfg = cfg.enerf if isinstance(cfg, Config) else cfg
    if not isinstance(enerf_cfg, ENeRFConfig):
        raise TypeError(f"expected a Config or ENeRFConfig, got {type(cfg)}")
    gen = torch.Generator().manual_seed(seed)
    return ENeRF(enerf_cfg, generator=gen).train(train).to(dev)


def to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A batch dict of numpy arrays / tensors as float32 tensors on
    ``device`` (non-array entries are dropped)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device=device, dtype=torch.float32).contiguous()
    return out


@torch.inference_mode()
def render(model: ENeRF, batch: Mapping, stage_hook=None) -> Dict[str, torch.Tensor]:
    """Render one batch with ``model`` on the model's device."""
    dev = next(model.parameters()).device
    return model(to_device(batch, dev), stage_hook=stage_hook)


__all__ = ["build_model", "render", "resolve_device", "to_device", "ENeRF"]
