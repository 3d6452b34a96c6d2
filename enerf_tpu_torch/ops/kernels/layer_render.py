"""Layered render of the composite model's last level: the CUDA kernel
``csrc/layer_render.cu``, its wrapper ``layer_render``, the route rule
``takes`` and the plain PyTorch version ``layer_render_plain``.

Per ray of the frame it shades the background sample with the bg head
and, inside the fg window, the foreground sample with the fg head, each
from its layer's image features and source rgb (two tensors: no
features ‖ rgb table is made), and alpha-composites fg then bg: rgb,
depth = Σ weights · z and weights, as ``composite_layers`` computes them
after the fg layer's paste into zeros of the frame. The heads' products
run on the tensor cores in three TF32 passes (f32-accurate), as the
render kernels'. The JAX package runs this chain on XLA
(``render_rays_packed_xla``'s raw mode and ``raw2outputs_composite``).

The features are float32 or bfloat16 (the bf16 compute mode, whose FPNs
output bf16): the kernel is templated on their type and converts them to
float32 as it samples them, as the plain version's table promotes them;
everything else is float32.

On a CPU tensor ``layer_render`` runs the plain version; on a CUDA tensor
it launches the kernel, or raises for inputs it is not built for. It
refuses inputs that need a gradient. ``takes`` says whether a level's
layers are for this route at all; the model runs the plain chain
otherwise (training, several fg layers, several samples a layer).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from enerf_tpu_torch.ops.composite import composite_layers
from enerf_tpu_torch.ops.ibr import get_img_feat
from enerf_tpu_torch.ops.kernels import _build
from enerf_tpu_torch.ops.kernels.render import head_params

FEAT_CH = 8            # image feature channels of a view (the FPN's level 2)
HID = 64               # NeRFHead hidden width
AGG = 16               # Agg's aggregated width, lr0's input without a volume
KERNEL_S = (2, 3, 4)   # source views the kernel is built for
HEAD_SIZE = 9066       # floats of one packed head (``HeadLayout::SIZE``)
_FEAT_DTYPES = (torch.float32, torch.bfloat16)

# Launches since the last reset: ``launches`` with float32 features,
# ``launches_bf16`` with bfloat16 ones. Reset with ``reset_launches()``.
launches = 0
launches_bf16 = 0


def reset_launches() -> None:
    global launches, launches_bf16
    launches = launches_bf16 = 0


# enerf_layer_render(17 pointers, B, S, H, W, Hr, Wr, hr, wr, n_params,
# white_bkgd, feat_bf16, render_scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_void_p])


class Layer(NamedTuple):
    """One layer's samples at the level and what shades them."""

    world_xyz: torch.Tensor   # (B, N, n, 3)
    z_vals: torch.Tensor      # (B, N, n), as composited (1/z on a disparity level)
    feat: torch.Tensor        # (B, S, H, W, C) image features at render scale
    rgb: torch.Tensor         # (B, S, H, W, 3) source rgb at render scale
    head: torch.nn.Module     # the layer's NeRFHead (no volume feature)


def shade_raw(world_xyz: torch.Tensor, table: torch.Tensor, head,
              src_exts: torch.Tensor, src_ixts: torch.Tensor,
              tar_ext: torch.Tensor, view_mask: Optional[torch.Tensor],
              render_scale: float, table_bf16: bool = False) -> torch.Tensor:
    """One layer's raw head output (B, N, n, 4) = rgb ‖ sigma at its
    samples world_xyz (B, N, n, 3), from the image table (B, S, H, W, C +
    3) = features ‖ rgb (``get_img_feat`` + the head without a volume
    feature)."""
    B, N, n = world_xyz.shape[:3]
    img_feat_rgb_dir = get_img_feat(world_xyz, table, src_exts, src_ixts,
                                    tar_ext, render_scale=render_scale,
                                    table_bf16=table_bf16)
    return head(None, img_feat_rgb_dir, view_mask).reshape(B, N, n, -1)


def _head_fits(head) -> bool:
    """A float32 NeRFHead without a volume feature, at the widths the
    kernel is built for."""
    return (not head.use_vox_feat and head.feat_ch == FEAT_CH + 3
            and tuple(head.lr0[0].weight.shape) == (HID, AGG)
            and tuple(head.color[0].weight.shape)
            == (HID, HID + AGG + FEAT_CH + 7)
            and all(p.dtype == torch.float32 for p in head.parameters()))


def takes(fg_heads: Sequence, bg_head, n_samples: int, feat: torch.Tensor,
          *tensors: Optional[torch.Tensor]) -> bool:
    """Whether a rendered level's layers take ``layer_render`` (else the
    model's plain chain): one fg layer, one sample a layer, heads that
    ``_head_fits``, 2..4 source views of float32 or bfloat16 features
    ``feat`` (B, S, H, W, 8), and no gradient to record through ``feat``,
    ``tensors`` or the heads."""
    heads = [*fg_heads, bg_head]
    if len(fg_heads) != 1 or n_samples != 1:
        return False
    if (feat.dim() != 5 or feat.shape[1] not in KERNEL_S
            or feat.shape[-1] != FEAT_CH or feat.dtype not in _FEAT_DTYPES):
        return False
    if not all(_head_fits(h) for h in heads):
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (feat, *tensors, *(p for h in heads for p in h.parameters()))))


def layer_render_plain(fg: Layer, bg: Layer, win, src_exts: torch.Tensor,
                       src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                       view_mask: Optional[torch.Tensor], *,
                       render_scale: float, white_bkgd: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version: each layer's table (features ‖ rgb) and
    raw head output (``shade_raw``), the fg layer's paste into zeros of
    the frame (``win.paste``) and ``composite_layers``; arguments as
    ``layer_render``."""
    B = bg.world_xyz.shape[0]
    (hr, wr), (Hr, Wr) = win.hw, win.frame_hw
    layers = [{"net_output": shade_raw(
        lay.world_xyz, torch.cat([lay.feat, lay.rgb], dim=-1), lay.head,
        src_exts, src_ixts, tar_ext, view_mask, render_scale),
        "z_vals": lay.z_vals} for lay in (fg, bg)]
    layers[0] = {k: win.paste(v.reshape((B, hr, wr) + v.shape[2:])
                              ).reshape((B, Hr * Wr) + v.shape[2:])
                 for k, v in layers[0].items()}
    return composite_layers(layers, num_fg_layers=1, white_bkgd=white_bkgd)


def layer_render(fg: Layer, bg: Layer, win, src_exts: torch.Tensor,
                 src_ixts: torch.Tensor, tar_ext: torch.Tensor,
                 view_mask: Optional[torch.Tensor], *, render_scale: float,
                 white_bkgd: bool = False) -> Dict[str, torch.Tensor]:
    """Shade and composite a level's fg and bg layers.

    ``bg``: the frame's rays, world_xyz (B, Hr·Wr, 1, 3) and z_vals (B,
    Hr·Wr, 1) in raster order; ``fg``: the rays of the window ``win`` (an
    ``ops.window.Window`` of hw (hr, wr) in the (Hr, Wr) frame, its origin
    clamped on the device), (B, hr·wr, 1, 3) and (B, hr·wr, 1). Each
    layer's feat (B, S, H, W, 8) and rgb (B, S, H, W, 3) at render scale;
    src_exts (B, S, 4, 4); src_ixts (B, S, 3, 3) unscaled; tar_ext (B, 4,
    4); view_mask (B, S) or None. Returns {'rgb' (B, Hr·Wr, 3), 'depth'
    (B, Hr·Wr), 'weights' (B, Hr·Wr, 2)}.

    On a CUDA tensor the kernel runs, for the inputs ``takes`` admits (any
    other raises ``ValueError``). The kernel has no backward: with
    gradients enabled, an input or a head parameter that requires one
    raises ``ValueError`` on every device."""
    heads = (fg.head, bg.head)
    _build.refuse_grad(
        "layer_render", "layer_render_plain",
        *(t for lay in (fg, bg) for t in lay[:4]), src_exts, src_ixts,
        tar_ext, view_mask,
        *(p for h in heads for p in h.parameters())
        if torch.is_grad_enabled() else ())
    if bg.world_xyz.device.type == "cpu":
        return layer_render_plain(fg, bg, win, src_exts, src_ixts, tar_ext,
                                  view_mask, render_scale=render_scale,
                                  white_bkgd=white_bkgd)
    return _launch(fg, bg, win, src_exts, src_ixts, tar_ext, view_mask,
                   render_scale, white_bkgd)


def _launch(fg, bg, win, src_exts, src_ixts, tar_ext, view_mask,
            render_scale, white_bkgd):
    req = _build.require
    dev = bg.world_xyz.device
    B, N, n, _ = bg.world_xyz.shape
    _, S, H, W, C = bg.feat.shape
    (hr, wr), (Hr, Wr) = win.hw, win.frame_hw
    Nf = hr * wr
    req(dev.type == "cuda", "layer_render kernel needs a CUDA tensor, got {}",
        dev)
    req(n == 1 and fg.world_xyz.shape[2] == 1 and C == FEAT_CH
        and S in KERNEL_S, "the layer_render kernel is built for 1 sample a "
        "layer, {} feature channels and S in {}; got n={}, C={}, S={}",
        FEAT_CH, KERNEL_S, n, C, S)
    req(N == Hr * Wr, "the bg layer has {} rays for a {}x{} frame", N, Hr, Wr)
    req(all(_head_fits(h) for h in (fg.head, bg.head)),
        "the layer_render kernel needs float32 NeRFHeads without a volume "
        "feature, {} image channels and hidden width {}", FEAT_CH + 3, HID)
    feat_dt = bg.feat.dtype
    req(feat_dt in _FEAT_DTYPES and fg.feat.dtype == feat_dt,
        "layer_render kernel takes float32 or bfloat16 features of one type, "
        "got {} and {}", fg.feat.dtype, feat_dt)
    if view_mask is None:
        view_mask = torch.ones(B, S, dtype=torch.float32, device=dev)
    view_mask = view_mask.to(torch.float32)
    xy0 = win.xy0
    params = torch.cat([head_params(fg.head), head_params(bg.head)])
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("fg world_xyz", fg.world_xyz, (B, Nf, 1, 3), f32),
            ("fg z_vals", fg.z_vals, (B, Nf, 1), f32),
            ("fg feat", fg.feat, (B, S, H, W, C), feat_dt),
            ("fg rgb", fg.rgb, (B, S, H, W, 3), f32),
            ("bg world_xyz", bg.world_xyz, (B, N, 1, 3), f32),
            ("bg z_vals", bg.z_vals, (B, N, 1), f32),
            ("bg feat", bg.feat, (B, S, H, W, C), feat_dt),
            ("bg rgb", bg.rgb, (B, S, H, W, 3), f32),
            ("window origin", xy0, (B, 2), torch.int64),
            ("src_exts", src_exts, (B, S, 4, 4), f32),
            ("src_ixts", src_ixts, (B, S, 3, 3), f32),
            ("tar_ext", tar_ext, (B, 4, 4), f32),
            ("view_mask", view_mask, (B, S), f32),
            ("head params", params, (2 * HEAD_SIZE,), f32)):
        req(t.device == dev, "{} is on {}, rays on {}", name, t.device, dev)
        req(t.dtype == dtype, "{} must be {}, got {}", name, dtype, t.dtype)
        req(t.is_contiguous(), "{} must be contiguous", name)
        req(tuple(t.shape) == shape, "{} has shape {}, expected {}", name,
            tuple(t.shape), shape)

    rgb = torch.empty(B, N, 3, dtype=f32, device=dev)
    depth = torch.empty(B, N, dtype=f32, device=dev)
    weights = torch.empty(B, N, 2, dtype=f32, device=dev)
    feat_bf16 = feat_dt == torch.bfloat16
    fn = _build.load_function("layer_render", "enerf_layer_render", _ARGTYPES)
    rc = fn(fg.world_xyz.data_ptr(), fg.z_vals.data_ptr(), fg.feat.data_ptr(),
            fg.rgb.data_ptr(), bg.world_xyz.data_ptr(), bg.z_vals.data_ptr(),
            bg.feat.data_ptr(), bg.rgb.data_ptr(), xy0.data_ptr(),
            src_exts.data_ptr(), src_ixts.data_ptr(), tar_ext.data_ptr(),
            view_mask.data_ptr(), params.data_ptr(), rgb.data_ptr(),
            depth.data_ptr(), weights.data_ptr(), B, S, H, W, Hr, Wr, hr, wr,
            int(params.numel()), int(white_bkgd), int(feat_bf16),
            float(render_scale), _build.stream_handle(dev))
    _build.check_rc("layer_render", rc)
    global launches, launches_bf16
    if feat_bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return {"rgb": rgb, "depth": depth, "weights": weights}
