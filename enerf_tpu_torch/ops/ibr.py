"""Image-based-rendering feature gathering; counterpart of
``enerf_tpu/ops/ibr.py`` (``get_vox_feat``, ``get_vox_feat_grid``,
``get_img_feat``, ``unpreprocess``). These are the plain pieces of the
fused render kernel (``ops/kernels/render.py``).
"""

from __future__ import annotations

import torch

from enerf_tpu_torch.ops.camera import cam_centers, scale_intrinsics
from enerf_tpu_torch.ops.sampling import (
    bilinear_sample_2d_multi,
    resize_bilinear,
    scale_size,
    trilinear_sample_3d_multi,
)


def get_vox_feat(uvd: torch.Tensor, feature_volume: torch.Tensor) -> torch.Tensor:
    """Trilinear sample (zeros padding, align_corners) of the regularized
    feature volume. uvd (B, N, 3) in [0, 1] (u, v, d); feature_volume
    (B, D, H, W, C). Returns (B, N, C)."""
    D, H, W = feature_volume.shape[1:4]
    x = uvd[..., 0] * (W - 1)
    y = uvd[..., 1] * (H - 1)
    z = uvd[..., 2] * (D - 1)
    return trilinear_sample_3d_multi(feature_volume, x, y, z,
                                     padding_mode="zeros")


def get_vox_feat_grid(feat_volume: torch.Tensor, d: torch.Tensor,
                      out_hw, window=None) -> torch.Tensor:
    """Trilinear volume sampling when the rays are the FULL raster grid:
    an align-corners spatial resize of the volume to the render size, then
    a tent-weighted contraction over the D planes (the tent is the
    two-corner lerp of grid_sample and is 0 outside [k-1, k+1], so zeros
    padding in depth comes out by itself). Equals ``get_vox_feat`` on grid
    rays.

    feat_volume (B, D, Hv, Wv, C); d (B, N) volume-normalized depth, N =
    H*W*n ray-major. ``window``, an ``ops.window.Window`` of the ``out_hw``
    frame: the rays are the raster sub-grid of that (wh, ww) window, and
    N = wh*ww*n. Returns (B, N, C)."""
    B, D, Hv, Wv, C = feat_volume.shape
    H, W = out_hw
    vol = resize_bilinear(feat_volume, (H, W))
    if window is not None:
        vol = window.crop(vol, planes=True)
        H, W = window.hw
    vol = vol.reshape(B, D, H * W, C)
    n = d.shape[1] // (H * W)
    z = d.reshape(B, H * W, n) * (D - 1)
    ks = torch.arange(D, dtype=z.dtype, device=z.device)
    w = torch.clamp(1.0 - torch.abs(z[..., None] - ks), min=0.0)
    out = torch.einsum("bpnd,bdpc->bpnc", w, vol)
    return out.reshape(B, H * W * n, C)


def get_img_feat(world_xyz: torch.Tensor, img_feat_rgb: torch.Tensor,
                 src_exts: torch.Tensor, src_ixts: torch.Tensor,
                 tar_ext: torch.Tensor, render_scale: float) -> torch.Tensor:
    """Per-source-view projected features + ray-difference geometry.

    world_xyz (B, N, n, 3); img_feat_rgb (B, S, H, W, C) (features ‖ rgb);
    src_exts (B, S, 4, 4); src_ixts (B, S, 3, 3); tar_ext (B, 4, 4).
    Returns (B, N*n, S, C+4): per view [feat‖rgb, ray_diff_dir(3), dot(1)].
    The image sample uses border padding in pixel coordinates."""
    B, N, n, _ = world_xyz.shape
    xyz = world_xyz.reshape(B, N * n, 3)
    tar_cam = cam_centers(tar_ext)                     # (B, 3)
    src_cam = cam_centers(src_exts)                    # (B, S, 3)
    ixt = scale_intrinsics(src_ixts, render_scale)     # (B, S, 3, 3)

    R = src_exts[..., :3, :3]
    t = src_exts[..., :3, 3]
    cam_pts = torch.einsum("bpc,bsdc->bpsd", xyz, R) + t[:, None]
    img_pts = torch.einsum("bpsd,bsed->bpse", cam_pts, ixt)
    z = torch.clamp(img_pts[..., 2:], min=1e-6)
    grid = img_pts[..., :2] / z                        # (B, P, S, 2)
    S, C = img_feat_rgb.shape[1], img_feat_rgb.shape[-1]
    feat = bilinear_sample_2d_multi(
        img_feat_rgb.reshape(B * S, *img_feat_rgb.shape[2:]),
        torch.movedim(grid[..., 0], -1, 1).reshape(B * S, -1),
        torch.movedim(grid[..., 1], -1, 1).reshape(B * S, -1),
        padding_mode="border")
    feat = torch.movedim(feat.reshape(B, S, -1, C), 1, 2)  # (B, P, S, C)

    tar_diff = xyz - tar_cam[:, None]
    src_diff = xyz[:, :, None] - src_cam[:, None]
    tar_diff = tar_diff / (torch.linalg.norm(tar_diff, dim=-1, keepdim=True)
                           + 1e-6)
    src_diff = src_diff / (torch.linalg.norm(src_diff, dim=-1, keepdim=True)
                           + 1e-6)
    ray_diff = tar_diff[:, :, None] - src_diff
    ray_diff_norm = torch.linalg.norm(ray_diff, dim=-1, keepdim=True)
    ray_diff_dot = torch.sum(tar_diff[:, :, None] * src_diff, dim=-1,
                             keepdim=True)
    ray_diff_dir = ray_diff / torch.clamp(ray_diff_norm, min=1e-6)
    return torch.cat([feat, ray_diff_dir, ray_diff_dot], dim=-1)


def unpreprocess(src_inps: torch.Tensor, render_scale: float = 1.0) -> torch.Tensor:
    """Source images stored in [-1, 1] → [0, 1], optionally rescaled.
    src_inps (B, S, H, W, 3)."""
    img = src_inps * 0.5 + 0.5
    if render_scale != 1.0:
        H, W = img.shape[2:4]
        img = resize_bilinear(img, (scale_size(H, render_scale),
                                    scale_size(W, render_scale)))
    return img
