"""PyTorch / CUDA port of ENeRF-TPU, held against the JAX package
``enerf_tpu`` (which it never imports).

Entry points::

    model = enerf_tpu_torch.build_model(cfg)            # on the GPU
    out = enerf_tpu_torch.render(model, batch)          # numpy or tensor batch

``cfg.network_module`` picks the network: the DTU cascade (``ENeRF``), the
human variant (``ENeRFHuman``, renders inside ``mask_at_box``) or the
composite variant (``ENeRFComposite``, fg layers in ``bbox`` windows over
a bg volume).

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
from enerf_tpu_torch.factory import make_network
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


def build_model(cfg, device=None, seed: int = 0, train: bool = False
                ) -> ENeRF:
    """The network ``cfg.network_module`` names (``ENeRF``, ``ENeRFHuman``
    or ``ENeRFComposite``; an ``ENeRFConfig`` alone gives ``ENeRF``),
    weights initialized from ``seed``, on ``device`` (default: the GPU), in
    eval mode, or in training mode when ``train``."""
    dev = resolve_device(device)
    if isinstance(cfg, ENeRFConfig):
        cfg = Config(enerf=cfg)
    if not isinstance(cfg, Config):
        raise TypeError(f"expected a Config or ENeRFConfig, got {type(cfg)}")
    gen = torch.Generator().manual_seed(seed)
    return make_network(cfg, generator=gen).train(train).to(dev)


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
