"""Fused render stage of one cascade level: the CUDA kernels
``csrc/render.cu`` (level 1's head shape) and ``csrc/render_l0.cu`` (level
0's head shape), each with the head's products on the tensor cores in
three TF32 passes (f32-accurate), their wrapper, and their plain PyTorch
version.

Replaces ``enerf_tpu/ops/pallas/render.py:fused_render_rays`` (kernels
``_render_kernel`` → ``_render_math`` and ``_render_kernel_v5``). Per ray,
for its n depth-guided samples and S source views: project and sample the
source features+rgb (border padding), the ray-difference direction and
dot, the Agg head (view_fc, masked mean / unbiased var, global_fc, masked
softmax pooling, fc), the trilinear vox feature of the level's feature
volume, σ = softplus(sigma(lr0([vox, agg]))), the per-view color MLP with a
masked softmax blend of the source rgb, and alpha compositing
(α = 1 − exp(−σ), no dists; depth = softmax(weights)·z).

The feature volume is float32 or bfloat16 (the bf16 compute mode, where
the 3D CNN outputs it in bf16): each kernel is templated on the volume's
type, converts it to float32 as it samples it, and keeps its float32
inputs, head and arithmetic, as the TPU kernel reads a bf16 volume and
f32 head weights (``enerf_tpu/ops/pallas/render.py:195-196,576``).

On a CPU tensor ``render_rays`` runs the plain version; on a CUDA tensor
it launches the kernel built for the head's shape, or raises. It refuses
inputs that need a gradient; the training path calls ``render_rays_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from enerf_tpu_torch.ops.composite import raw2outputs
from enerf_tpu_torch.ops.ibr import get_img_feat, get_vox_feat, get_vox_feat_grid
from enerf_tpu_torch.ops.kernels import _build

# The head shapes the kernels are compiled for, (image channels Cf,
# volume channels Cv, samples a ray n) → (kernel library, C function):
# level 1 of the cascade (8 FPN channels + rgb, 2 samples) and level 0 (32
# + rgb, 8 samples), each over an 8-channel feature volume and 2..4 source
# views, with the NeRFHead widths (hidden 64, global 32, aggregated 16).
KERNELS = {(11, 8, 2): ("render", "enerf_render_rays"),
           (35, 8, 8): ("render_l0", "enerf_render_rays_l0")}
KERNEL_S = (2, 3, 4)

# Launches since the last reset, by kernel library (``KERNELS``): "render"
# for csrc/render.cu, "render_l0" for csrc/render_l0.cu; ``launches`` of
# their float32-volume variants, ``launches_bf16`` of their bfloat16-volume
# ones. Reset with ``reset_launches()``.
launches = {lib: 0 for lib, _ in KERNELS.values()}
launches_bf16 = {lib: 0 for lib, _ in KERNELS.values()}
_VOLUME_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (launches, launches_bf16):
        for lib in counts:
            counts[lib] = 0


# enerf_render_rays[_l0](13 pointers, B, N, S, H, W, Dv, Hv, Wv, n_params,
# white_bkgd, vol_bf16, render_scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_void_p])


def head_params(head) -> torch.Tensor:
    """The NeRFHead's weights as the kernels' flat f32 buffer: each
    Linear's (out, in) weight then its bias, in the order view_fc,
    global_fc, agg_w_fc, fc, lr0, sigma, color.0, color.2 (``HeadLayout``
    of ``csrc/render.cu``, ``csrc/render_l0.cu`` and
    ``csrc/layer_render.cu``). A head without view-direction aggregation
    (the composite's) gives zeros for view_fc, which then adds relu(0) = 0
    to every view's features."""
    agg = head.agg
    layers = [agg.global_fc[0], agg.agg_w_fc[0], agg.fc[0], head.lr0[0],
              head.sigma[0], head.color[0], head.color[2]]
    if head.viewdir_agg:
        view = [agg.view_fc[0].weight, agg.view_fc[0].bias]
    else:
        w = agg.global_fc[0].weight
        view = [w.new_zeros(head.feat_ch * 4), w.new_zeros(head.feat_ch)]
    return torch.cat([t.reshape(-1) for t in view]
                     + [t.reshape(-1) for lin in layers
                        for t in (lin.weight, lin.bias)]).to(torch.float32)


def render_rays_plain(world_xyz: torch.Tensor, uvd: torch.Tensor,
                      z_vals: torch.Tensor, img_feat_rgb: torch.Tensor,
                      feat_volume: torch.Tensor, src_exts: torch.Tensor,
                      src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                      view_mask: Optional[torch.Tensor], head, *,
                      render_scale: float, white_bkgd: bool = False,
                      grid_hw: Optional[Tuple[int, int]] = None, window=None,
                      table_bf16: bool = False) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version: ``get_img_feat`` + vox features
    (``get_vox_feat_grid`` on grid rays, else ``get_vox_feat``) + the
    NeRFHead module + ``raw2outputs``, in float32 or wider (a bfloat16
    volume is converted first, as the kernels convert it). Arguments as
    ``render_rays``; ``table_bf16`` rounds the image table ``img_feat_rgb``
    to bfloat16 before it is sampled (``get_img_feat``), as training in
    the bf16 mode does."""
    B, N, n, _ = world_xyz.shape
    feat_volume = feat_volume.to(torch.promote_types(feat_volume.dtype,
                                                     torch.float32))
    if grid_hw is not None:
        vox = get_vox_feat_grid(feat_volume, uvd.reshape(B, -1, 3)[..., 2],
                                grid_hw, window=window)
    else:
        vox = get_vox_feat(uvd.reshape(B, -1, 3), feat_volume)
    img_feat_rgb_dir = get_img_feat(world_xyz, img_feat_rgb, src_exts,
                                    src_ixts, tar_ext, render_scale,
                                    table_bf16=table_bf16)
    raw = head(vox, img_feat_rgb_dir, view_mask).reshape(B, N, n, -1)
    return raw2outputs(raw, z_vals, white_bkgd)


def render_rays(world_xyz: torch.Tensor, uvd: torch.Tensor,
                z_vals: torch.Tensor, img_feat_rgb: torch.Tensor,
                feat_volume: torch.Tensor, src_exts: torch.Tensor,
                src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                view_mask: Optional[torch.Tensor], head, *,
                render_scale: float, white_bkgd: bool = False,
                grid_hw: Optional[Tuple[int, int]] = None, window=None
                ) -> Dict[str, torch.Tensor]:
    """Shade and composite the depth-guided samples of one cascade level.

    world_xyz (B, N, n, 3); uvd (B, N, n, 3) normalized to [0, 1] (u, v at
    render scale, d inside the volume bounds); z_vals (B, N, n);
    img_feat_rgb (B, S, H, W, Cf) image features ‖ rgb at render scale;
    feat_volume (B, D, Hv, Wv, Cv), float32 or bfloat16 (every other input
    float32; on a CUDA tensor another volume type raises); src_exts (B, S, 4, 4); src_ixts
    (B, S, 3, 3) unscaled; tar_ext (B, 4, 4); view_mask (B, S) or None;
    head the level's NeRFHead. ``grid_hw``: the rays are the (H, W) raster
    grid, or with ``window`` (an ``ops.window.Window`` of that frame) the
    raster sub-grid of the window (the plain version then samples the
    volume by resize + tent; the kernel samples it trilinearly at uvd
    either way, which is the same function). Returns {'rgb' (B, N, 3),
    'depth' (B, N), 'weights' (B, N, n)}.

    On a CUDA tensor the head's shape (Cf, Cv, n) picks the kernel
    (``KERNELS``: ``csrc/render.cu`` for level 1's (11, 8, 2),
    ``csrc/render_l0.cu`` for level 0's (35, 8, 8)); any other shape
    raises ``ValueError``. The kernels have no backward: with gradients
    enabled, an input or a head parameter that requires one raises
    ``ValueError`` on every device (training calls ``render_rays_plain``)."""
    _build.refuse_grad("render", "render_rays_plain", world_xyz, uvd, z_vals,
                       img_feat_rgb, feat_volume, src_exts, src_ixts, tar_ext,
                       view_mask,
                       *(head.parameters() if torch.is_grad_enabled() else ()))
    if world_xyz.device.type == "cpu":
        return render_rays_plain(world_xyz, uvd, z_vals, img_feat_rgb,
                                 feat_volume, src_exts, src_ixts, tar_ext,
                                 view_mask, head, render_scale=render_scale,
                                 white_bkgd=white_bkgd, grid_hw=grid_hw,
                                 window=window)
    return _launch(world_xyz, uvd, z_vals, img_feat_rgb, feat_volume,
                   src_exts, src_ixts, tar_ext, view_mask, head,
                   render_scale, white_bkgd)


def _launch(world_xyz, uvd, z_vals, img_feat_rgb, feat_volume, src_exts,
            src_ixts, tar_ext, view_mask, head, render_scale, white_bkgd):
    req = _build.require
    B, N, n, _ = world_xyz.shape
    _, S, H, W, Cf = img_feat_rgb.shape
    _, Dv, Hv, Wv, Cv = feat_volume.shape
    dev = world_xyz.device
    kernel = KERNELS.get((Cf, Cv, n))
    req(kernel is not None and S in KERNEL_S,
        "the render kernels are built for (Cf, Cv, n) in {} and S in {}; got "
        "Cf={}, Cv={}, n={}, S={}", sorted(KERNELS), KERNEL_S, Cf, Cv, n, S)
    req(dev.type == "cuda", "render kernel needs a CUDA tensor, got {}", dev)
    req(head.viewdir_agg and head.use_vox_feat,
        "render kernel needs a NeRFHead with viewdir_agg and use_vox_feat")
    req(feat_volume.dtype in _VOLUME_DTYPES, "render kernel takes a float32 "
        "or bfloat16 feat_volume, got {}", feat_volume.dtype)
    vol_bf16 = feat_volume.dtype == torch.bfloat16
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
        req(t.dtype == torch.float32 or t is feat_volume,
            "{} must be float32, got {}", name, t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(shape is None or tuple(t.shape) == shape,
            "{} has shape {}, expected {}", name, tuple(t.shape), shape)
    req(feat_volume.data_ptr() % 16 == 0, "feat_volume must be 16-byte aligned")

    rgb = torch.empty(B, N, 3, dtype=torch.float32, device=dev)
    depth = torch.empty(B, N, dtype=torch.float32, device=dev)
    weights = torch.empty(B, N, n, dtype=torch.float32, device=dev)
    fn = _build.load_function(*kernel, _ARGTYPES)
    rc = fn(world_xyz.data_ptr(), uvd.data_ptr(), z_vals.data_ptr(),
            img_feat_rgb.data_ptr(), feat_volume.data_ptr(),
            src_exts.data_ptr(), src_ixts.data_ptr(), tar_ext.data_ptr(),
            view_mask.data_ptr(), params.data_ptr(), rgb.data_ptr(),
            depth.data_ptr(), weights.data_ptr(), B, N, S, H, W, Dv, Hv, Wv,
            int(params.numel()), int(white_bkgd), int(vol_bf16),
            float(render_scale), _build.stream_handle(dev))
    _build.check_rc(kernel[0], rc)
    (launches_bf16 if vol_bf16 else launches)[kernel[0]] += 1
    return {"rgb": rgb, "depth": depth, "weights": weights}
