"""The network named by the config; counterpart of ``make_network`` in
``enerf_tpu/factory.py``.

The JAX package imports the module that ``cfg.network_module`` names and
builds its ``Network``. The port never imports that module: it maps the
module's last component to its own class by a table of names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from enerf_tpu_torch.config import Config
from enerf_tpu_torch.models.enerf import ENeRF
from enerf_tpu_torch.models.enerf_composite import ENeRFComposite
from enerf_tpu_torch.models.enerf_human import ENeRFHuman

NETWORKS = {
    "enerf": ENeRF,
    "enerf_human": ENeRFHuman,
    "enerf_composite": ENeRFComposite,
}


def network_class(cfg: Config) -> type:
    """The port's class for ``cfg.network_module``; raises ``ValueError``
    for a module it has no counterpart of."""
    name = cfg.network_module.rsplit(".", 1)[-1]
    if name not in NETWORKS:
        raise ValueError(
            f"network_module {cfg.network_module!r} has no counterpart in "
            f"enerf_tpu_torch (known: {sorted(NETWORKS)})")
    return NETWORKS[name]


def make_network(cfg: Config,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """The network ``cfg.network_module`` names, weights drawn from
    ``generator``, on the CPU in training mode (``nn.Module``'s default)."""
    return network_class(cfg)(cfg.enerf, generator=generator)
