"""Seeded weights and BN statistics for a configuration, made on the device
in a few large draws from ``torch.Generator``, keyed as the published
state dict (``reference.enerf.param_spec``). Both the program (through
``load_state_dict``) and the reference take these same tensors.

Convs take torch's default uniform ±1/sqrt(fan_in) (bias likewise); the
IBR head's Linears kaiming-normal weights (std sqrt(2 / fan_in)) with a
small uniform bias; BN scale in [0.75, 1.25], shift in [-0.1, 0.1],
running mean in [-0.1, 0.1] and running variance in [0.5, 1.5], so that
eval mode's BN does real work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the BN tensors' uniform ranges by kind
_UNIFORM = {"bn_w": (0.75, 1.25), "bn_b": (-0.1, 0.1),
            "bn_mean": (-0.1, 0.1), "bn_var": (0.5, 1.5)}


def make_state(spec: List[Tuple[str, Tuple[int, ...], str, int]], seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec`` drawn from ``seed`` on ``device``: one
    uniform and one normal draw for all tensors, cut and scaled."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape, kind, _ in spec]
    total = sum(sizes)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    state, off = {}, 0
    for (key, shape, kind, fan), n in zip(spec, sizes):
        u, z = uni[off:off + n].view(shape), nrm[off:off + n].view(shape)
        off += n
        if kind == "bn_count":
            state[key] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in _UNIFORM:
            lo, hi = _UNIFORM[kind]
            state[key] = lo + (hi - lo) * u
        elif kind in ("conv_w", "conv_b"):
            b = 1.0 / math.sqrt(fan)
            state[key] = (2.0 * u - 1.0) * b
        elif kind == "lin_w":
            state[key] = z * math.sqrt(2.0 / fan)
        elif kind == "lin_b":
            state[key] = (2.0 * u - 1.0) * 0.05
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {key}")
    return {k: v.contiguous() for k, v in state.items()}
