"""The network and the evaluator named by the config; counterpart of
``make_network`` and ``make_evaluator`` in ``enerf_tpu/factory.py``.

The JAX package imports the module that ``cfg.network_module`` (or
``cfg.evaluator_module``) names and builds its ``Network`` (or
``Evaluator``). The port never imports that module: it maps the module's
last component to its own class by a table of names. The evaluators are
imported only when one is asked for, so building a network does not load
the evaluation layer (LPIPS, scipy).
"""

from __future__ import annotations

import importlib
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


# the port's evaluator modules, each holding an ``Evaluator``
EVALUATORS = {
    "evaluator": "enerf_tpu_torch.eval.evaluator",
    "evaluator_human": "enerf_tpu_torch.eval.evaluator_human",
    "evaluator_composite": "enerf_tpu_torch.eval.evaluator_composite",
}


def _lookup(key: str, module: str, table: dict):
    name = module.rsplit(".", 1)[-1]
    if name not in table:
        raise ValueError(f"{key} {module!r} has no counterpart in "
                         f"enerf_tpu_torch (known: {sorted(table)})")
    return table[name]


def network_class(cfg: Config) -> type:
    """The port's class for ``cfg.network_module``; raises ``ValueError``
    for a module it has no counterpart of."""
    return _lookup("network_module", cfg.network_module, NETWORKS)


def evaluator_class(cfg: Config) -> type:
    """The port's class for ``cfg.evaluator_module``; raises
    ``ValueError`` for a module it has no counterpart of."""
    module = _lookup("evaluator_module", cfg.evaluator_module, EVALUATORS)
    return importlib.import_module(module).Evaluator


def make_evaluator(cfg: Config, **kwargs):
    """The evaluator ``cfg.evaluator_module`` names; ``kwargs`` go to its
    constructor (``device`` for LPIPS, default the GPU; ``lpips_path``)."""
    return evaluator_class(cfg)(cfg, **kwargs)


def make_network(cfg: Config,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """The network ``cfg.network_module`` names, weights drawn from
    ``generator``, on the CPU in training mode (``nn.Module``'s default)."""
    return network_class(cfg)(cfg.enerf, generator=generator)
