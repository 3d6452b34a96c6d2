"""Plain PyTorch reference of ENeRF-Outdoor's layered foreground /
background model (Lin et al., "Efficient Neural Radiance Fields for
Interactive Free-viewpoint Video", SIGGRAPH Asia 2022, §ENeRF-Outdoor; code
github.com/zju3dv/ENeRF, ``lib/networks/enerf/network_composite.py``,
``nerf_.py`` and ``utils.py:raw2outputs_composite``), float32, for the
benchmark's ``correct`` check.

It imports neither the program under test nor JAX. The parameters are a
flat dict keyed as the model's state dict (``feature_net.*``,
``feature_net_bg.*``, ``cost_reg_{i}_layer{l}.*``, ``cost_reg_{i}_bg.*``,
``nerf_{i}_layer{l}.*``, ``nerf_{i}_bg.*``); the FPN, the MinCostRegNet,
the variance volume, the planes and the depth regression are
``reference/enerf.py``'s layer functions. Added here:

- the head without a volume feature (``nerf_.py``): sigma and the colour
  weights read the 16-channel aggregate of the views alone;
- per level and fg layer, the cost volume of a window at the layer's
  ``bbox`` origin (the pixel grid shifted into the projection), its
  MinCostRegNet, its depth logits pasted into zeros of the full frame;
  the rays inside the window at render scale gathered by their pixel,
  shaded raw and scattered back (zeros elsewhere);
- the background: a full-frame volume of ``bg_volume_planes`` planes on
  the second FPN's features, its own MinCostRegNet and depth, every ray
  shaded raw from the background plates ``bg_src_inps``;
- the samples, the fg layer's first, then the bg's, alpha-composited
  together (one fg layer, as ``actor1.yaml``; several would be z-sorted
  first):
  weights = alpha · exclusive cumprod(1 − alpha + 1e-10), rgb = Σ
  weights · rgb, depth = Σ weights · z (``raw2outputs_composite``).

Its one departure from ``network_composite.py``: the window has the fixed
size ``fg_bbox_hw`` (at each scale ``int(size · scale)``), its origin the
bbox's ``int(x · scale), int(y · scale)`` clamped into the frame, where
the published code crops the bbox of each frame rounded to a multiple of
32. The program and the JAX package fix it so; the benchmark's scenes
give bboxes whose window lies inside the frame, as the ENeRF-Outdoor
dataset clamps it.

Layouts as ``reference/enerf.py``; a batch also holds ``bg_src_inps``
(B, S, H, W, 3), ``bbox`` (B, L, 4) x, y, w, h at full resolution and
``near_far`` (B, L + 1, 2): the fg layers' then the background's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import enerf as ref

Params = Dict[str, torch.Tensor]


def head_layers(feat_ch: int, viewdir_agg: bool) -> Tuple[Tuple[str, int, int], ...]:
    """The head without a volume feature (``nerf_.py``): (name, in, out) of
    each Linear; ``feat_ch`` the image channels of a view (FPN features +
    rgb)."""
    view = (("agg.view_fc.0", 4, feat_ch),) if viewdir_agg else ()
    return view + (("agg.global_fc.0", 3 * feat_ch, 32), ("agg.agg_w_fc.0", 32, 1),
                   ("agg.fc.0", 32, 16), ("lr0.0", 16, 64), ("sigma.0", 64, 1),
                   ("color.0", 64 + 16 + feat_ch + 4, 64), ("color.2", 64, 1))


def layer_names(num_fg_layers: int) -> List[str]:
    return [f"layer{l}" for l in range(num_fg_layers)] + ["bg"]


def param_spec(cas: dict, num_fg_layers: int, viewdir_agg: bool
               ) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every tensor of the composite's state dict (key, shape, kind,
    fan_in), as ``reference.enerf.param_spec``: two FPNs, and a
    MinCostRegNet and a head a level for each fg layer and the
    background."""
    fpn = ref.param_spec(dict(cas, num=0))
    spec = fpn + [("feature_net_bg" + k[len("feature_net"):], shape, kind, fan)
                  for k, shape, kind, fan in fpn]

    def bn(pre, c):
        spec.extend([(f"{pre}.weight", (c,), "bn_w", c), (f"{pre}.bias", (c,), "bn_b", c),
                     (f"{pre}.running_mean", (c,), "bn_mean", c),
                     (f"{pre}.running_var", (c,), "bn_var", c),
                     (f"{pre}.num_batches_tracked", (), "bn_count", 1)])

    for i in range(cas["num"]):
        feat_ch = cas["nerf_model_feat_ch"][i] + 3
        for name in layer_names(num_fg_layers):
            for layer, kind, cin, cout, _ in ref.COST_REG_MIN:
                cin = ref.FEAT_CH[i] if cin is None else cin
                pre = f"cost_reg_{i}_{name}.{layer}"
                if kind == "cbr3":
                    spec.append((f"{pre}.conv.weight", (cout, cin, 3, 3, 3), "conv_w",
                                 cin * 27))
                    bn(f"{pre}.bn", cout)
                elif kind == "ctb":
                    spec.append((f"{pre}.0.weight", (cin, cout, 3, 3, 3), "conv_w",
                                 cout * 27))
                    bn(f"{pre}.1", cout)
                else:
                    spec.append((f"{pre}.weight", (cout, cin, 3, 3, 3), "conv_w", cin * 27))
            for lin, cin, cout in head_layers(feat_ch, viewdir_agg):
                spec.append((f"nerf_{i}_{name}.{lin}.weight", (cout, cin), "lin_w", cin))
                spec.append((f"nerf_{i}_{name}.{lin}.bias", (cout,), "lin_b", cin))
    return spec


def _sub(p: Params, pre: str, as_pre: str) -> Params:
    """The tensors under ``pre.``, keyed under ``as_pre.``."""
    return {as_pre + k[len(pre):]: v for k, v in p.items() if k.startswith(pre + ".")}


def head_raw(p: Params, pre: str, views: torch.Tensor, mask: torch.Tensor,
             viewdir_agg: bool) -> torch.Tensor:
    """The head without a volume feature on P samples: views (P, S, C + 4)
    = features ‖ rgb ‖ ray-difference direction (3) ‖ dot (1), mask (S,)
    bool → (P, 4) = rgb ‖ sigma."""
    m = mask.view(1, -1, 1)
    feat = views[..., :-4]
    if viewdir_agg:
        feat = feat + ref._linear_relu(p, f"{pre}.agg.view_fc.0", views[..., -4:])
    w = m.to(feat.dtype)
    cnt = w.sum(dim=1, keepdim=True).clamp(min=1.0)
    mean = (feat * w).sum(dim=1, keepdim=True) / cnt
    var = (((feat - mean) ** 2) * w).sum(dim=1, keepdim=True) / (cnt - 1.0).clamp(min=1.0)
    g = ref._linear_relu(p, f"{pre}.agg.global_fc.0",
                         torch.cat([feat, var.expand_as(feat), mean.expand_as(feat)], -1))
    aw = ref._masked_softmax(ref._linear_relu(p, f"{pre}.agg.agg_w_fc.0", g), m, 1)
    agg = ref._linear_relu(p, f"{pre}.agg.fc.0", (g * aw).sum(dim=1))      # (P, 16)
    h = ref._linear_relu(p, f"{pre}.lr0.0", agg)
    sigma = F.softplus(F.linear(h, p[f"{pre}.sigma.0.weight"], p[f"{pre}.sigma.0.bias"]))
    shared = torch.cat([h, agg], dim=-1)                                   # (P, 80)
    w0, b0 = p[f"{pre}.color.0.weight"], p[f"{pre}.color.0.bias"]
    n_shared = shared.shape[-1]
    x = F.relu(F.linear(shared, w0[:, :n_shared])[:, None]
               + F.linear(views, w0[:, n_shared:], b0))
    cw = ref._masked_softmax(ref._linear_relu(p, f"{pre}.color.2", x), m, 1)
    color = (views[..., -7:-4] * cw).sum(dim=1)
    return torch.cat([color, sigma], dim=-1)


def render_raw(p, pre, cas, level, rays, depth, std, nf, img_table, src_exts,
               src_ixts, tar_ext, view_mask, H, W, viewdir_agg, chunk=65536):
    """The raw samples of the rays (N, 8) of one batch item at ``level``
    (render frame (H, W)) under the head ``pre``: bounds from the level's
    depth pdf at each ray's pixel, samples, the views' features, the head.
    Returns raw (N, n, 4) and z (N, n) as depth (1/z on a disparity
    level)."""
    inv = cas["depth_inv"][level]
    up = (H, W)
    d, s, nfu = ref._up(depth[None], up)[0], ref._up(std[None], up)[0], ref._up(nf[None], up)[0]
    if inv:
        r0, r1 = torch.minimum(d + s, nfu[0]), torch.maximum(d - s, nfu[1])
    else:
        r0, r1 = torch.maximum(d - s, nfu[0]), torch.minimum(d + s, nfu[1])
    px, py = rays[:, 6].long(), rays[:, 7].long()
    near, far = r0[py, px], r1[py, px]
    n = cas["num_samples"][level]
    lin = torch.linspace(0.0, 1.0, n, dtype=rays.dtype, device=rays.device)
    z = near[:, None] + (far - near)[:, None] * lin if n > 1 else (
        (near + (far - near) * 0.5)[:, None])
    t = 1.0 / z.clamp(min=1e-6) if inv else z
    pts = (rays[:, None, :3] + rays[:, None, 3:6] * t[..., None]).reshape(-1, 3)
    S, C, Ht, Wt = img_table.shape
    K = ref._scale_k(src_ixts, cas["render_scale"][level])
    cam = torch.einsum("sij,pj->psi", src_exts[:, :3, :3], pts) + src_exts[:, :3, 3]
    img = torch.einsum("sij,psj->psi", K, cam)
    zz = img[..., 2:].clamp(min=1e-6)
    g = torch.stack([img[..., 0:1] / zz / (Wt - 1) * 2 - 1,
                     img[..., 1:2] / zz / (Ht - 1) * 2 - 1], dim=-1)[..., 0, :]
    feat = F.grid_sample(img_table, g.permute(1, 0, 2)[:, None], mode="bilinear",
                         padding_mode="border", align_corners=True)[:, :, 0]
    feat = feat.permute(2, 0, 1)                                     # (P, S, C)
    tdir = pts - ref._cam_center(tar_ext)
    tdir = tdir / (tdir.norm(dim=-1, keepdim=True) + 1e-6)
    sdir = pts[:, None] - ref._cam_center(src_exts)
    sdir = sdir / (sdir.norm(dim=-1, keepdim=True) + 1e-6)
    diff = tdir[:, None] - sdir
    ddir = diff / diff.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    dot = (tdir[:, None] * sdir).sum(dim=-1, keepdim=True)
    views = torch.cat([feat, ddir, dot], dim=-1)
    mask = view_mask > 0
    raw = torch.cat([head_raw(p, pre, views[i:i + chunk], mask, viewdir_agg)
                     for i in range(0, views.shape[0], chunk)])
    return raw.reshape(-1, n, 4), (1.0 / z.clamp(min=1e-6) if inv else z)


def window_origin(bbox_xy: torch.Tensor, scale: float, hw: Tuple[int, int],
                  frame_hw: Tuple[int, int]) -> torch.Tensor:
    """The (B, 2) [x0, y0] origin of the (h, w) window at ``scale``:
    ``int(x · scale)``, clamped so that the window lies in the frame."""
    xy = (bbox_xy.float() * scale).to(torch.int64)
    x = xy[:, 0].clamp(0, frame_hw[1] - hw[1])
    y = xy[:, 1].clamp(0, frame_hw[0] - hw[0])
    return torch.stack([x, y], dim=-1)


def _shifted(P: torch.Tensor, x0: int, y0: int) -> torch.Tensor:
    """``P`` (.., 4, 4) composed with the map of the window's homogeneous
    (x·d, y·d, d, 1) to the frame's, the pixel (x + x0, y + y0)."""
    P = P.clone()
    P[..., 2] = P[..., 2] + x0 * P[..., 0] + y0 * P[..., 1]
    return P


def _table(feats, src, cas, level, B, S, H0, W0):
    """The level's image table (B, S, C + 3, H, W) at render scale: the
    FPN level it names, resized, ‖ the source rgb."""
    rs = cas["render_scale"][level]
    H, W = int(H0 * rs), int(W0 * rs)
    im = feats[cas["render_im_feat_level"][level]]
    up = rs / cas["im_ibr_scale"][level]
    if up != 1.0:
        im = ref._up(im, (int(math.floor(im.shape[-2] * up)),
                          int(math.floor(im.shape[-1] * up))))
    rgb = (src * 0.5 + 0.5).reshape(B * S, H0, W0, 3).permute(0, 3, 1, 2)
    if rs != 1.0:
        rgb = ref._up(rgb, (H, W))
    return torch.cat([im, rgb], dim=1).reshape(B, S, -1, H, W)


def forward(p: Params, stats: Params, cfg: dict, batch: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """The composite in eval mode on ``batch``; ``cfg`` holds ``cas``
    (the cascade), ``num_fg_layers``, ``bg_volume_planes``,
    ``fg_bbox_hw`` and ``viewdir_agg``. Returns {rgb, depth}_level{i} of
    every rendered level."""
    cas, L = cfg["cas"], cfg["num_fg_layers"]
    if L != 1:
        # several fg layers' samples would be z-sorted before the bg's
        raise NotImplementedError("the reference composites one fg layer")
    fg_h, fg_w = cfg["fg_bbox_hw"]
    src, bg_src = batch["src_inps"], batch["bg_src_inps"]
    B, S, H0, W0, _ = src.shape
    x = src.reshape(B * S, H0, W0, 3).permute(0, 3, 1, 2)
    feats = ref.feature_net(p, stats, x, False)
    pb, sb = _sub(p, "feature_net_bg", "feature_net"), _sub(stats, "feature_net_bg",
                                                             "feature_net")
    feats_bg = ref.feature_net(pb, sb, x, False)
    view_mask = batch["view_mask"]
    names = layer_names(L)
    prev = {n: None for n in names}
    out = {}
    for i in range(cas["num"]):
        vs, rs = cas["volume_scale"][i], cas["render_scale"][i]
        Hv, Wv = int(math.floor(H0 * vs)), int(math.floor(W0 * vs))
        H, W = int(H0 * rs), int(W0 * rs)
        P = ref.proj_mats(batch["src_exts"], batch["src_ixts"], batch["tar_ext"],
                          batch["tar_ixt"], cas["im_feat_scale"][i], vs)
        raws, zs = [], []
        for l, name in enumerate(names):
            fg = name != "bg"
            D = cas["volume_planes"][i] if fg else cfg["bg_volume_planes"][i]
            nf_in = batch["near_far"][:, l] if fg else batch["near_far"][:, -1]
            if prev[name] is None:
                planes, nf = ref.first_planes(nf_in, D, Hv, Wv, cas["depth_inv"][i])
            else:
                d0, s0, nf0 = prev[name]
                planes, nf = ref.next_planes(d0, s0, nf0, D, cas["depth_inv"][i - 1],
                                             cas["depth_inv"][i], (Hv, Wv))
            f = (feats if fg else feats_bg)[i]
            f = f.reshape(B, S, *f.shape[1:])
            pre = f"cost_reg_{i}_{name}"
            pc, sc = _sub(p, pre, f"cost_reg_{i}"), _sub(stats, pre, f"cost_reg_{i}")
            if fg:
                hv, wv = int(fg_h * vs), int(fg_w * vs)
                xy = window_origin(batch["bbox"][:, l, :2], vs, (hv, wv), (Hv, Wv))
                logits = planes.new_zeros(B, D, Hv, Wv)
                for b in range(B):
                    x0, y0 = int(xy[b, 0]), int(xy[b, 1])
                    crop = planes[b:b + 1, :, y0:y0 + hv, x0:x0 + wv]
                    vol = ref.variance_volume(f[b:b + 1], _shifted(P[b:b + 1], x0, y0),
                                              crop, view_mask[b:b + 1])
                    _, lg = ref.cost_reg(pc, sc, i, False, vol, False)
                    logits[b, :, y0:y0 + hv, x0:x0 + wv] = lg[0]
            else:
                vol = ref.variance_volume(f, P, planes, view_mask)
                _, logits = ref.cost_reg(pc, sc, i, False, vol, False)
            depth, std = ref.regress_depth(logits, planes, cas["depth_inv"][i])
            prev[name] = (depth, std, nf)
            if not cas["render_if"][i]:
                continue
            table = _table(feats if fg else feats_bg, src if fg else bg_src, cas, i,
                           B, S, H0, W0)
            n = cas["num_samples"][i]
            N = batch[f"rays_{i}"].shape[1]
            raw_l = src.new_zeros(B, N, n, 4)
            z_l = src.new_zeros(B, N, n)
            for b in range(B):
                rays = batch[f"rays_{i}"][b]
                if fg:
                    hr, wr = int(fg_h * rs), int(fg_w * rs)
                    xr = window_origin(batch["bbox"][b:b + 1, l, :2], rs, (hr, wr), (H, W))[0]
                    px, py = rays[:, 6].long(), rays[:, 7].long()
                    keep = torch.nonzero((px >= xr[0]) & (px < xr[0] + wr)
                                         & (py >= xr[1]) & (py < xr[1] + hr))[:, 0]
                else:
                    keep = torch.arange(N, device=rays.device)
                raw, z = render_raw(p, f"nerf_{i}_{name}", cas, i, rays[keep], depth[b],
                                    std[b], nf[b], table[b], batch["src_exts"][b],
                                    batch["src_ixts"][b], batch["tar_ext"][b],
                                    view_mask[b], H, W, cfg["viewdir_agg"])
                raw_l[b, keep], z_l[b, keep] = raw, z
            raws.append(raw_l)
            zs.append(z_l)
        if not cas["render_if"][i]:
            continue
        raw, z = torch.cat(raws, dim=2), torch.cat(zs, dim=2)
        alpha = 1.0 - torch.exp(-raw[..., 3])
        trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                         1.0 - alpha[..., :-1] + 1e-10], -1), -1)
        w = alpha * trans
        out[f"rgb_level{i}"] = (w[..., None] * raw[..., :3]).sum(dim=-2)
        out[f"depth_level{i}"] = (w * z).sum(dim=-1)
    return out
