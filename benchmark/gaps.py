"""The gap statistics of one output against the reference, for the loops
whose outputs ``compare.render_gaps`` does not name (the composite's
``rgb`` and ``depth``; a validation's levels): of |got − want| over a
scale, the widest (``max``), the root mean square (``rms``), the median
(``p50``) and the 99th percentile (``p99``); all ``inf`` where the
program's output is not finite."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

STATS = ("max", "rms", "p50", "p99")


def gap_stats(got, want: torch.Tensor, scale: float,
              pick: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """``got`` (a tensor or numpy array of ``want``'s size) against
    ``want``; ``pick`` (N,) bool, where given, the rays (leading rows of
    ``want`` reshaped to (N, -1)) compared."""
    a = torch.as_tensor(got).to(want.device, torch.float32).reshape(want.shape)
    if not bool(torch.isfinite(a).all()):
        return dict.fromkeys(STATS, math.inf)
    d = (a - want).abs()
    if pick is not None:
        d = d.reshape(pick.shape[0], -1)[pick]
    d = d.flatten().double() / scale
    q = torch.quantile(d, torch.tensor([0.5, 0.99], dtype=d.dtype, device=d.device))
    return {"max": float(d.max()), "rms": float(d.pow(2).mean().sqrt()),
            "p50": float(q[0]), "p99": float(q[1])}
