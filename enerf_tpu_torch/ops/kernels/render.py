"""Fused render stage of one cascade level: the CUDA kernel
``csrc/render.cu`` (the head's products on the tensor cores in three TF32
passes, f32-accurate), its wrapper, and its plain PyTorch version.

Replaces ``enerf_tpu/ops/pallas/render.py:fused_render_rays`` (kernels
``_render_kernel`` → ``_render_math`` and ``_render_kernel_v5``). Per ray,
for its n depth-guided samples and S source views: project and sample the
source features+rgb (border padding), the ray-difference direction and
dot, the Agg head (view_fc, masked mean / unbiased var, global_fc, masked
softmax pooling, fc), the trilinear vox feature of the level's feature
volume, σ = softplus(sigma(lr0([vox, agg]))), the per-view color MLP with a
masked softmax blend of the source rgb, and alpha compositing
(α = 1 − exp(−σ), no dists; depth = softmax(weights)·z).

On a CPU tensor ``render_rays`` runs the plain version; on a CUDA tensor
it launches the kernel or raises. It refuses inputs that need a gradient;
the training path calls ``render_rays_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from enerf_tpu_torch.ops.composite import raw2outputs
from enerf_tpu_torch.ops.ibr import get_img_feat, get_vox_feat, get_vox_feat_grid
from enerf_tpu_torch.ops.kernels import _build

# Launches of the CUDA kernel since the last reset (set to 0 to reset).
launches = 0

# The shapes the kernel is compiled for: 8 image-feature channels + rgb,
# an 8-channel feature volume, 2 samples per ray, 2..4 source views, and
# the NeRFHead widths (hidden 64, global 32, aggregated 16).
KERNEL_CF = 11
KERNEL_CV = 8
KERNEL_NS = 2
KERNEL_S = (2, 3, 4)


def head_params(head) -> torch.Tensor:
    """The NeRFHead's weights as the kernel's flat f32 buffer: each Linear's
    (out, in) weight then its bias, in the order view_fc, global_fc,
    agg_w_fc, fc, lr0, sigma, color.0, color.2 (``csrc/render.cu``
    ``HeadLayout``)."""
    agg = head.agg
    layers = [agg.view_fc[0], agg.global_fc[0], agg.agg_w_fc[0], agg.fc[0],
              head.lr0[0], head.sigma[0], head.color[0], head.color[2]]
    return torch.cat([t.reshape(-1) for lin in layers
                      for t in (lin.weight, lin.bias)]).to(torch.float32)


def render_rays_plain(world_xyz: torch.Tensor, uvd: torch.Tensor,
                      z_vals: torch.Tensor, img_feat_rgb: torch.Tensor,
                      feat_volume: torch.Tensor, src_exts: torch.Tensor,
                      src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                      view_mask: Optional[torch.Tensor], head, *,
                      render_scale: float, white_bkgd: bool = False,
                      grid_hw: Optional[Tuple[int, int]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version: ``get_img_feat`` + vox features
    (``get_vox_feat_grid`` on grid rays, else ``get_vox_feat``) + the
    NeRFHead module + ``raw2outputs``. Arguments as ``render_rays``."""
    B, N, n, _ = world_xyz.shape
    if grid_hw is not None:
        vox = get_vox_feat_grid(feat_volume, uvd.reshape(B, -1, 3)[..., 2],
                                grid_hw)
    else:
        vox = get_vox_feat(uvd.reshape(B, -1, 3), feat_volume)
    img_feat_rgb_dir = get_img_feat(world_xyz, img_feat_rgb, src_exts,
                                    src_ixts, tar_ext, render_scale)
    raw = head(vox, img_feat_rgb_dir, view_mask).reshape(B, N, n, -1)
    return raw2outputs(raw, z_vals, white_bkgd)


def render_rays(world_xyz: torch.Tensor, uvd: torch.Tensor,
                z_vals: torch.Tensor, img_feat_rgb: torch.Tensor,
                feat_volume: torch.Tensor, src_exts: torch.Tensor,
                src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                view_mask: Optional[torch.Tensor], head, *,
                render_scale: float, white_bkgd: bool = False,
                grid_hw: Optional[Tuple[int, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """Shade and composite the depth-guided samples of one cascade level.

    world_xyz (B, N, n, 3); uvd (B, N, n, 3) normalized to [0, 1] (u, v at
    render scale, d inside the volume bounds); z_vals (B, N, n);
    img_feat_rgb (B, S, H, W, Cf) image features ‖ rgb at render scale;
    feat_volume (B, D, Hv, Wv, Cv); src_exts (B, S, 4, 4); src_ixts
    (B, S, 3, 3) unscaled; tar_ext (B, 4, 4); view_mask (B, S) or None;
    head the level's NeRFHead. ``grid_hw``: the rays are the (H, W) raster
    grid (the plain version then samples the volume by resize + tent; the
    kernel samples it trilinearly at uvd either way, which is the same
    function). Returns {'rgb' (B, N, 3), 'depth' (B, N), 'weights'
    (B, N, n)}.

    The kernel has no backward: with gradients enabled, an input or a head
    parameter that requires one raises ``ValueError`` on every device
    (training calls ``render_rays_plain``)."""
    _build.refuse_grad("render", "render_rays_plain", world_xyz, uvd, z_vals,
                       img_feat_rgb, feat_volume, src_exts, src_ixts, tar_ext,
                       view_mask,
                       *(head.parameters() if torch.is_grad_enabled() else ()))
    if world_xyz.device.type == "cpu":
        return render_rays_plain(world_xyz, uvd, z_vals, img_feat_rgb,
                                 feat_volume, src_exts, src_ixts, tar_ext,
                                 view_mask, head, render_scale=render_scale,
                                 white_bkgd=white_bkgd, grid_hw=grid_hw)
    return _launch(world_xyz, uvd, z_vals, img_feat_rgb, feat_volume,
                   src_exts, src_ixts, tar_ext, view_mask, head,
                   render_scale, white_bkgd)


def _launch(world_xyz, uvd, z_vals, img_feat_rgb, feat_volume, src_exts,
            src_ixts, tar_ext, view_mask, head, render_scale, white_bkgd):
    global launches
    req = _build.require
    B, N, n, _ = world_xyz.shape
    _, S, H, W, Cf = img_feat_rgb.shape
    _, Dv, Hv, Wv, Cv = feat_volume.shape
    dev = world_xyz.device
    req(dev.type == "cuda", "render kernel needs a CUDA tensor, got {}", dev)
    req((Cf, Cv, n) == (KERNEL_CF, KERNEL_CV, KERNEL_NS) and S in KERNEL_S,
        "render kernel is built for Cf={}, Cv={}, n={}, S in {}; got Cf={}, "
        "Cv={}, n={}, S={}", KERNEL_CF, KERNEL_CV, KERNEL_NS, KERNEL_S, Cf,
        Cv, n, S)
    req(head.viewdir_agg, "render kernel needs a NeRFHead with viewdir_agg")
    if view_mask is None:
        view_mask = torch.ones(B, S, dtype=torch.float32, device=dev)
    view_mask = view_mask.to(torch.float32)
    params = head_params(head).contiguous()
    for name, t, shape in (("world_xyz", world_xyz, (B, N, n, 3)),
                           ("uvd", uvd, (B, N, n, 3)),
                           ("z_vals", z_vals, (B, N, n)),
                           ("img_feat_rgb", img_feat_rgb, (B, S, H, W, Cf)),
                           ("feat_volume", feat_volume, (B, Dv, Hv, Wv, Cv)),
                           ("src_exts", src_exts, (B, S, 4, 4)),
                           ("src_ixts", src_ixts, (B, S, 3, 3)),
                           ("tar_ext", tar_ext, (B, 4, 4)),
                           ("view_mask", view_mask, (B, S)),
                           ("head params", params, None)):
        req(t.device == dev, "{} is on {}, rays on {}", name, t.device, dev)
        req(t.dtype == torch.float32, "{} must be float32, got {}", name,
            t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(shape is None or tuple(t.shape) == shape,
            "{} has shape {}, expected {}", name, tuple(t.shape), shape)
    req(feat_volume.data_ptr() % 16 == 0, "feat_volume must be 16-byte aligned")

    rgb = torch.empty(B, N, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(B, N, dtype=torch.float32, device=dev)
    weights = torch.empty(B, N, n, dtype=torch.float32, device=dev)
    lib = _build.load_library("render")
    fn = lib.enerf_render_rays
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(world_xyz.data_ptr(), uvd.data_ptr(), z_vals.data_ptr(),
            img_feat_rgb.data_ptr(), feat_volume.data_ptr(),
            src_exts.data_ptr(), src_ixts.data_ptr(), tar_ext.data_ptr(),
            view_mask.data_ptr(), params.data_ptr(), rgb.data_ptr(),
            depth.data_ptr(), weights.data_ptr(), B, N, S, H, W, Dv, Hv, Wv,
            int(params.numel()), int(white_bkgd), float(render_scale),
            _build.stream_handle(dev))
    _build.check_rc("render", rc)
    launches += 1
    return {"rgb": rgb, "depth": depth, "weights": weights}
