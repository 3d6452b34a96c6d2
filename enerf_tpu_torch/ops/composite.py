"""Alpha compositing of per-sample radiance; counterpart of
``_exclusive_cumprod`` and ``raw2outputs`` in ``enerf_tpu/ops/composite.py``.

ENeRF's peculiarities: alpha = 1 - exp(-sigma) with **no dists term**
(samples are depth-guided), and the depth map is softmax(weights)·z, not
Σ weights·z, with z held constant: no gradient reaches z_vals through it
(``jax.lax.stop_gradient`` in the JAX package).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod over the last axis shifted right by one, with a leading 1
    (the transmittance)."""
    cp = torch.cumprod(x, dim=-1)[..., :-1]
    return torch.cat([torch.ones_like(x[..., :1]), cp], dim=-1)


def raw2outputs(raw: torch.Tensor, z_vals: Optional[torch.Tensor],
                white_bkgd: bool = False) -> Dict[str, torch.Tensor]:
    """raw (B, N, n, 4) = rgb(3)‖sigma(1); z_vals (B, N, n).

    Returns {'rgb' (B, N, 3), 'depth' (B, N), 'weights' (B, N, n)}."""
    alpha = 1.0 - torch.exp(-raw[..., 3])
    rgb = raw[..., :3]
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    out = {"rgb": rgb_map, "weights": weights}
    if z_vals is not None:
        out["depth"] = torch.sum(torch.softmax(weights, dim=-1)
                                 * z_vals.detach(), dim=-1)
    if white_bkgd:
        out["rgb"] = rgb_map + (1.0 - torch.sum(weights, dim=-1)[..., None])
    return out
