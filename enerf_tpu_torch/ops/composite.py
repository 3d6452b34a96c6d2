"""Alpha compositing of per-sample radiance; counterpart of
``enerf_tpu/ops/composite.py`` (reference lib/networks/enerf/utils.py:
488-603: raw2outputs and its two variants, which the stock forward does not
use; 889-942: raw2outputs_composite, the composite model's
``composite_layers``).

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


def _composite(raw: torch.Tensor, z_vals: torch.Tensor, alpha: torch.Tensor,
               white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """rgb as Σ weights·rgb and depth as Σ weights·z (z held constant)."""
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * raw[..., :3], dim=-2)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1)[..., None])
    return {"rgb": rgb_map,
            "depth": torch.sum(weights * z_vals.detach(), dim=-1),
            "weights": weights}


def raw2outputs_ngp(raw: torch.Tensor, z_vals: torch.Tensor,
                    raydir: torch.Tensor, white_bkgd: bool = False,
                    n_samples: int = 32) -> Dict[str, torch.Tensor]:
    """The variant with a dists term (reference utils.py:488-525): alpha =
    1 - exp(-sigma · dist), the dists along the ray in world units; with
    more than ``n_samples`` samples the leading ones take dist 1. raw (...,
    n, 4), z_vals (..., n), raydir (..., 3). Returns {'rgb', 'depth',
    'weights'}, depth as Σ weights·z."""
    dists_z = z_vals * torch.linalg.norm(raydir, dim=-1, keepdim=True)
    dists = dists_z[..., 1:] - dists_z[..., :-1]
    dists = torch.cat([dists, dists[..., -1:]], dim=-1)
    total = dists.shape[-1]
    if total > n_samples:
        lead = torch.arange(total, device=dists.device) < total - n_samples
        dists = torch.where(lead, torch.ones_like(dists), dists)
    alpha = 1.0 - torch.exp(-raw[..., 3] * dists)
    return _composite(raw, z_vals, alpha, white_bkgd)


def raw2outputs_layer(net_outputs, z_vals_list, white_bkgd: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Multi-layer compositing in z order (reference utils.py:527-568).

    net_outputs: list of (..., n_i, 4); z_vals_list: list of (..., n_i).
    The layers' samples are merged and sorted by z (a stable sort, as
    ``jnp.argsort``: samples of two layers can tie in z), then composited.
    Returns {'rgb', 'depth', 'weights', 'idx', 'net_output', 'z_vals'}, the
    last two unsorted."""
    raw = torch.cat(list(net_outputs), dim=-2)
    z = torch.cat(list(z_vals_list), dim=-1)
    idx = torch.argsort(z, dim=-1, stable=True)
    z_sorted = torch.take_along_dim(z, idx, dim=-1)
    raw_sorted = torch.take_along_dim(raw, idx[..., None], dim=-2)
    alpha = 1.0 - torch.exp(-raw_sorted[..., 3])
    out = _composite(raw_sorted, z_sorted, alpha, white_bkgd)
    out.update(idx=idx, net_output=raw, z_vals=z)
    return out


def composite_layers(layers, num_fg_layers: int, white_bkgd: bool
                     ) -> Dict[str, torch.Tensor]:
    """The fg layers' samples (``layers[:num_fg_layers]``) z-sorted when
    there are several, the bg samples (``layers[-1]``) appended, then
    alpha-composited (reference utils.py:889-942 raw2outputs_composite):
    rgb, depth = Σ weights·z (z held constant), weights."""
    net_output = torch.cat([lay["net_output"] for lay in layers[:num_fg_layers]],
                           dim=-2)
    z_vals = torch.cat([lay["z_vals"] for lay in layers[:num_fg_layers]],
                       dim=-1)
    if num_fg_layers > 1:
        idx = torch.argsort(z_vals, dim=-1, stable=True)
        z_vals = torch.take_along_dim(z_vals, idx, dim=-1)
        net_output = torch.take_along_dim(net_output, idx[..., None], dim=-2)
    net_output = torch.cat([net_output, layers[-1]["net_output"]], dim=-2)
    z_vals = torch.cat([z_vals, layers[-1]["z_vals"]], dim=-1)

    alpha = 1.0 - torch.exp(-net_output[..., 3])
    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10)
    rgb_map = torch.sum(weights[..., None] * net_output[..., :3], dim=-2)
    depth_map = torch.sum(weights * z_vals.detach(), dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1)[..., None])
    return {"rgb": rgb_map, "depth": depth_map, "weights": weights}
