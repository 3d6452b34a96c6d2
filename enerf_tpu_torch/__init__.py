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

From dataset files on disk (``python -m enerf_tpu_torch.run``)::

    from enerf_tpu_torch.datasets.loader import make_data_loader
    for batch in make_data_loader(cfg, "test"):         # numpy batches
        out = enerf_tpu_torch.render(model, batch)

Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every CUDA kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from enerf_tpu_torch.config import Config, ENeRFConfig
from enerf_tpu_torch.datasets.loader import device_batch
from enerf_tpu_torch.factory import make_network
from enerf_tpu_torch.models.enerf import ENeRF
from enerf_tpu_torch.utils.profiling import span


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


@torch.inference_mode()
def render(model: ENeRF, batch: Mapping, stage_hook=None, **kwargs
           ) -> Dict[str, torch.Tensor]:
    """Render one batch with ``model`` on the model's device, in the span
    ``render`` (``utils/profiling.span``); only the batch's device inputs
    are uploaded (``device_batch``: the host-only ground truth
    ``tar_img``, ``tar_dpt``, ``tar_mask`` stays). ``kwargs`` go to the
    model's forward (``ray_slice``)."""
    with span("render"):
        dev = next(model.parameters()).device
        return model(device_batch(batch, dev), stage_hook=stage_hook,
                     **kwargs)


__all__ = ["build_model", "render", "resolve_device", "device_batch",
           "ENeRF"]
