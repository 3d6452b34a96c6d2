"""Depth-guided ray construction and sampling, and the plane and shell
samplers that the stock forward does not use; counterpart of
``enerf_tpu/ops/rays.py`` (reference lib/networks/enerf/utils.py:390-441,
730-794).

Ray layout (12 channels):
    ray_o(3) | ray_d(3) | uv(2) | ray_near, ray_far(2) | vol_near, vol_far(2)
"""

from __future__ import annotations

from typing import Tuple

import math

import torch

from enerf_tpu_torch.ops.depth import upsample_bounds


def _bounds(depth, std, near_far, depth_inv):
    if depth_inv:
        nf0 = torch.minimum(depth + std, near_far[:, 0])
        nf1 = torch.maximum(depth - std, near_far[:, 1])
    else:
        nf0 = torch.maximum(depth - std, near_far[:, 0])
        nf1 = torch.minimum(depth + std, near_far[:, 1])
    return torch.stack([nf0, nf1], dim=-1)           # (B, H, W, 2)


def build_rays(rays8: torch.Tensor, depth: torch.Tensor, std: torch.Tensor,
               near_far: torch.Tensor, depth_inv: bool, up_scale: float,
               grid: bool = False) -> torch.Tensor:
    """Append per-ray depth-guided bounds to host-built 8-ch rays.

    rays8 (B, N, 8) = o(3)|dir(3)|u|v at render scale; depth/std/near_far at
    volume scale (upsampled here by ``up_scale``). Returns (B, N, 12).
    ``grid``: the rays are the full raster grid in raster order, so the
    per-ray bound lookup is a reshape."""
    if up_scale != 1.0:
        depth, std, near_far = upsample_bounds(depth, std, near_far, up_scale)
    B = depth.shape[0]
    ray_nf = _bounds(depth, std, near_far, depth_inv)
    vol_nf = torch.movedim(near_far, 1, -1)            # (B, H, W, 2)
    if grid:
        ray_nf = ray_nf.reshape(B, -1, 2)
        vol_nf = vol_nf.reshape(B, -1, 2)
    else:
        uv = rays8[..., 6:8].long()
        bidx = torch.arange(B, device=rays8.device)[:, None]
        ray_nf = ray_nf[bidx, uv[..., 1], uv[..., 0]]
        vol_nf = vol_nf[bidx, uv[..., 1], uv[..., 0]]
    return torch.cat([rays8, ray_nf, vol_nf], dim=-1)


def sample_along_depth(rays: torch.Tensor, n_samples: int, depth_inv: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place n_samples points inside each ray's [near, far] interval.

    rays (B, N, 12). Returns (world_xyz (B, N, n, 3), uvd (B, N, n, 3),
    z_vals (B, N, n)). With ``depth_inv`` the interval is in disparity and
    the world point uses 1/z. uvd's d channel is the normalized position
    inside the *volume* bounds."""
    ray_o = rays[..., 0:3]
    ray_d = rays[..., 3:6]
    uv = rays[..., 6:8]
    ray_near = rays[..., 8:9]
    ray_far = rays[..., 9:10]
    vol_near = rays[..., 10:11]
    vol_far = rays[..., 11:12]

    if n_samples == 1:
        z_vals = ray_near + (ray_far - ray_near) * 0.5
    else:
        lin = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype,
                             device=rays.device)
        z_vals = ray_near + (ray_far - ray_near) * lin

    if depth_inv:
        t = 1.0 / torch.clamp(z_vals[..., None], min=1e-6)
    else:
        t = z_vals[..., None]
    world_xyz = ray_o[..., None, :] + ray_d[..., None, :] * t

    if depth_inv:
        d = (vol_near - z_vals) / torch.clamp(vol_near - vol_far, min=1e-6)
    else:
        d = (z_vals - vol_near) / torch.clamp(vol_far - vol_near, min=1e-6)
    uvd = torch.cat([uv[..., None, :].expand(*world_xyz.shape[:-1], 2),
                     d[..., None]], dim=-1)
    return world_xyz, uvd, z_vals


def sample_points_on_plane(rays: torch.Tensor, n_samples: int = 32,
                           bounds=((-4.0, -4.0, -0.2), (4.0, 4.0, 0.2))
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab sampling between two z-planes (reference utils.py:730-745).
    rays (..., >=6) o|dir. Returns (points normalized into ``bounds``
    (..., n, 3), z_vals (..., n))."""
    bounds = torch.as_tensor(bounds, dtype=rays.dtype, device=rays.device)
    ray_o_z = rays[..., 2]
    ray_d_z = rays[..., 5]
    # the two clamps of a near-zero z direction, in the reference's order
    ray_d_z = torch.where((ray_d_z > -1e-5) & (ray_d_z < 1e-10),
                          torch.full_like(ray_d_z, -1e-5), ray_d_z)
    ray_d_z = torch.where((ray_d_z < 1e-5) & (ray_d_z > -1e-10),
                          torch.full_like(ray_d_z, 1e-5), ray_d_z)
    near = (bounds[1, 2] - ray_o_z) / ray_d_z
    far = (bounds[0, 2] - ray_o_z) / ray_d_z
    lin = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype,
                         device=rays.device)
    z_vals = near[..., None] + (far - near)[..., None] * lin
    pts = rays[..., None, :3] + rays[..., None, 3:6] * z_vals[..., None]
    return (pts - bounds[0]) / (bounds[1] - bounds[0]), z_vals


def sample_points_along_sphere(rays: torch.Tensor, n_samples: int = 32,
                               r1: float = 3.0, r2: float = 4.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling through the cylindrical shell r1 < |xy| < r2 (reference
    utils.py:765-794). rays (..., >=6) o|dir. Returns ((theta, radial, z)
    coordinates (..., n, 3), z_vals (..., n))."""
    o = rays[..., :2]
    d = rays[..., 3:5]
    d_norm = torch.linalg.norm(d, dim=-1)
    d_n = d / d_norm[..., None]
    x1 = -torch.sum(o * d_n, dim=-1)
    x2_2 = torch.clamp(torch.sum(o * o, dim=-1) - x1 * x1, 1e-6,
                       r1 ** 2 - 1e-4)
    x3 = torch.sqrt(r1 ** 2 - x2_2)
    x4 = torch.sqrt(r2 ** 2 - x2_2)
    near = (x1 + x3) / d_norm
    far = (x1 + x4) / d_norm
    lin = torch.linspace(0.0, 1.0, n_samples, dtype=rays.dtype,
                         device=rays.device)
    z_vals = near[..., None] + (far - near)[..., None] * lin
    pts = rays[..., None, :3] + rays[..., None, 3:6] * z_vals[..., None]
    xy = pts[..., :2]
    xy_n = xy / torch.linalg.norm(xy, dim=-1, keepdim=True)
    theta = torch.where(xy_n[..., 1] >= 0, torch.arcsin(xy_n[..., 0]),
                        math.pi - torch.arcsin(xy_n[..., 0]))
    theta = (theta + math.pi / 2.0) / (2 * math.pi)
    yy = (torch.linalg.norm(pts[..., :2], dim=-1) - r1 + 0.1) / (r2 - r1 + 0.2)
    zz = (pts[..., 2] + 0.2) / 2.4
    return torch.stack([theta, yy, zz], dim=-1), z_vals
