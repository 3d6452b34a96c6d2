"""Plain PyTorch reference of ENeRF (Lin et al., "Efficient Neural Radiance
Fields for Interactive Free-viewpoint Video", SIGGRAPH Asia 2022; code
github.com/zju3dv/ENeRF, ``lib/networks/enerf``), float32, written from the
published layer list and equations for the benchmark's ``correct`` check.

It imports neither the program under test nor JAX: the parameters are a
flat dict keyed as the published state dict (``feature_net.*``,
``cost_reg_{i}.*``, ``nerf_{i}.*``), the layers are ``torch.nn.functional``
calls, and every derived quantity (projection matrices, depth planes, ray
bounds, samples, the human mask's rays) is worked out again here from the
inputs that the benchmark hands to both sides. It has no kernel, no grid
shortcut and no static window: volume features are sampled trilinearly at
each sample (bilinearly on every depth plane at the ray's pixel, then by
the hat weights of the sample's depth over the planes), and the human
variant gathers the masked rays and scatters them back.

Layouts: images (B, S, H, W, 3) in [-1, 1], extrinsics world-to-camera
4x4, intrinsics 3x3 at full resolution, rays (B, N, 8) = origin (3) |
direction (3) | pixel x, y at render scale.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# FPN (feature_net.py): (name, kind, in, out, kernel, stride, pad); "cbr" is
# conv (no bias) + BN + ReLU, "conv" a conv with a bias
FPN_LAYERS = (
    ("conv0.0", "cbr", 3, 8, 3, 1, 1), ("conv0.1", "cbr", 8, 8, 3, 1, 1),
    ("conv1.0", "cbr", 8, 16, 5, 2, 2), ("conv1.1", "cbr", 16, 16, 3, 1, 1),
    ("conv2.0", "cbr", 16, 32, 5, 2, 2), ("conv2.1", "cbr", 32, 32, 3, 1, 1),
    ("toplayer", "conv", 32, 32, 1, 1, 0), ("lat1", "conv", 16, 32, 1, 1, 0),
    ("lat0", "conv", 8, 32, 1, 1, 0), ("smooth1", "conv", 32, 16, 3, 1, 1),
    ("smooth0", "conv", 32, 8, 3, 1, 1),
)
# FPN output channels by level: level_0 at 1/4, level_1 at 1/2, level_2 full
FEAT_CH = {0: 32, 1: 16, 2: 8}
# 3D U-Nets (cost_reg_net.py): CostRegNet at the last level, MinCostRegNet
# (no deepest stage) before it; "cbr3" conv3d + BN + ReLU, "ctb" transposed
# conv3d (k3, s2, p1, output padding 1) + BN, "head" conv3d without bias
COST_REG_FULL = (
    ("conv0", "cbr3", None, 8, 1), ("conv1", "cbr3", 8, 16, 2),
    ("conv2", "cbr3", 16, 16, 1), ("conv3", "cbr3", 16, 32, 2),
    ("conv4", "cbr3", 32, 32, 1), ("conv5", "cbr3", 32, 64, 2),
    ("conv6", "cbr3", 64, 64, 1), ("conv7", "ctb", 64, 32, 2),
    ("conv9", "ctb", 32, 16, 2), ("conv11", "ctb", 16, 8, 2),
    ("feat_conv.0", "head", 8, 8, 1), ("depth_conv.0", "head", 8, 1, 1),
)
COST_REG_MIN = tuple(l for l in COST_REG_FULL
                     if l[0] not in ("conv5", "conv6", "conv7"))
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def head_layers(feat_ch: int) -> Tuple[Tuple[str, int, int], ...]:
    """The IBR head (nerf.py's Agg + NeRF): (name, in, out) of each Linear;
    ``feat_ch`` the image channels of a view (FPN features + rgb)."""
    return (("agg.view_fc.0", 4, feat_ch), ("agg.global_fc.0", 3 * feat_ch, 32),
            ("agg.agg_w_fc.0", 32, 1), ("agg.fc.0", 32, 16),
            ("lr0.0", 24, 64), ("sigma.0", 64, 1),
            ("color.0", 64 + 24 + feat_ch + 4, 64), ("color.2", 64, 1))


def param_spec(cas: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every tensor of the published state dict for cascade ``cas`` (the
    configuration's ``cas_config``): (key, shape, kind, fan_in), kind one of
    conv_w, conv_b, lin_w, lin_b, bn_w, bn_b, bn_mean, bn_var, bn_count."""
    spec = []

    def bn(pre, c):
        spec.extend([(f"{pre}.weight", (c,), "bn_w", c),
                     (f"{pre}.bias", (c,), "bn_b", c),
                     (f"{pre}.running_mean", (c,), "bn_mean", c),
                     (f"{pre}.running_var", (c,), "bn_var", c),
                     (f"{pre}.num_batches_tracked", (), "bn_count", 1)])

    for name, kind, cin, cout, k, _, _ in FPN_LAYERS:
        pre = f"feature_net.{name}"
        fan = cin * k * k
        if kind == "cbr":
            spec.append((f"{pre}.conv.weight", (cout, cin, k, k), "conv_w", fan))
            bn(f"{pre}.bn", cout)
        else:
            spec.append((f"{pre}.weight", (cout, cin, k, k), "conv_w", fan))
            spec.append((f"{pre}.bias", (cout,), "conv_b", fan))
    for i in range(cas["num"]):
        layers = COST_REG_FULL if i == cas["num"] - 1 else COST_REG_MIN
        for name, kind, cin, cout, _ in layers:
            cin = FEAT_CH[i] if cin is None else cin
            pre = f"cost_reg_{i}.{name}"
            if kind == "cbr3":
                spec.append((f"{pre}.conv.weight", (cout, cin, 3, 3, 3),
                             "conv_w", cin * 27))
                bn(f"{pre}.bn", cout)
            elif kind == "ctb":
                # torch's transposed-conv layout (in, out, k, k, k); its
                # default init reads fan_in from the weight's dim 1
                spec.append((f"{pre}.0.weight", (cin, cout, 3, 3, 3),
                             "conv_w", cout * 27))
                bn(f"{pre}.1", cout)
            else:
                spec.append((f"{pre}.weight", (cout, cin, 3, 3, 3), "conv_w",
                             cin * 27))
        feat_ch = cas["nerf_model_feat_ch"][i] + 3
        for name, cin, cout in head_layers(feat_ch):
            pre = f"nerf_{i}.{name}"
            spec.append((f"{pre}.weight", (cout, cin), "lin_w", cin))
            spec.append((f"{pre}.bias", (cout,), "lin_b", cin))
    return spec


# --------------------------------------------------------------------------
# layers


def _bn(x, p, pre, train, stats):
    """BatchNorm over dim 1: batch statistics in training (the running ones
    in ``stats`` move by ``BN_MOMENTUM``), the running statistics in eval."""
    mean, var = stats[f"{pre}.running_mean"], stats[f"{pre}.running_var"]
    return F.batch_norm(x, mean, var, p[f"{pre}.weight"], p[f"{pre}.bias"],
                        training=train, momentum=BN_MOMENTUM, eps=BN_EPS)


def feature_net(p: Params, stats: Params, x: torch.Tensor, train: bool
                ) -> Dict[int, torch.Tensor]:
    """FPN of (N, 3, H, W) images → {0: 32ch @1/4, 1: 16ch @1/2, 2: 8ch @1},
    NCHW."""
    def cbr(x, name):
        layer = next(l for l in FPN_LAYERS if l[0] == name)
        pre = f"feature_net.{name}"
        y = F.conv2d(x, p[f"{pre}.conv.weight"], None, layer[5], layer[6])
        return F.relu(_bn(y, p, f"{pre}.bn", train, stats))

    def conv(x, name):
        layer = next(l for l in FPN_LAYERS if l[0] == name)
        pre = f"feature_net.{name}"
        return F.conv2d(x, p[f"{pre}.weight"], p[f"{pre}.bias"], layer[5],
                        layer[6])

    def up_add(x, y):
        return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                             align_corners=True) + y

    c0 = cbr(cbr(x, "conv0.0"), "conv0.1")
    c1 = cbr(cbr(c0, "conv1.0"), "conv1.1")
    c2 = cbr(cbr(c1, "conv2.0"), "conv2.1")
    f2 = conv(c2, "toplayer")
    f1 = up_add(f2, conv(c1, "lat1"))
    f0 = up_add(f1, conv(c0, "lat0"))
    return {0: f2, 1: conv(f1, "smooth1"), 2: conv(f0, "smooth0")}


def cost_reg(p: Params, stats: Params, level: int, full: bool,
             vol: torch.Tensor, train: bool):
    """3D U-Net of the (B, C, D, H, W) variance volume → (feature volume
    (B, 8, D, H, W), depth logits (B, D, H, W))."""
    pre = f"cost_reg_{level}"

    def cbr3(x, name, stride):
        y = F.conv3d(x, p[f"{pre}.{name}.conv.weight"], None, stride, 1)
        return F.relu(_bn(y, p, f"{pre}.{name}.bn", train, stats))

    def ctb(x, name):
        y = F.conv_transpose3d(x, p[f"{pre}.{name}.0.weight"], None, 2, 1, 1)
        return _bn(y, p, f"{pre}.{name}.1", train, stats)

    c0 = cbr3(vol, "conv0", 1)
    c2 = cbr3(cbr3(c0, "conv1", 2), "conv2", 1)
    c4 = cbr3(cbr3(c2, "conv3", 2), "conv4", 1)
    if full:
        x = cbr3(cbr3(c4, "conv5", 2), "conv6", 1)
        x = c2 + ctb(c4 + ctb(x, "conv7"), "conv9")
    else:
        x = c2 + ctb(c4, "conv9")
    x = c0 + ctb(x, "conv11")
    feat = F.conv3d(x, p[f"{pre}.feat_conv.0.weight"], None, 1, 1)
    logits = F.conv3d(x, p[f"{pre}.depth_conv.0.weight"], None, 1, 1)[:, 0]
    return feat, logits


def _linear_relu(p, pre, x):
    return F.relu(F.linear(x, p[f"{pre}.weight"], p[f"{pre}.bias"]))


def _masked_softmax(logits, mask, dim):
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    return torch.softmax(logits, dim=dim)


def ibr_head(p: Params, level: int, vox: torch.Tensor, views: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The IBR head on P samples: vox (P, 8), views (P, S, C + 4) =
    features ‖ rgb ‖ ray-difference direction (3) ‖ dot (1), mask (S,) bool
    or None → (P, 4) = rgb ‖ sigma."""
    pre = f"nerf_{level}"
    m = None if mask is None else mask.view(1, -1, 1)
    feat = views[..., :-4] + _linear_relu(p, f"{pre}.agg.view_fc.0",
                                          views[..., -4:])
    if m is None:
        mean = feat.mean(dim=1, keepdim=True)
        var = ((feat - mean) ** 2).sum(dim=1, keepdim=True) / (feat.shape[1] - 1)
    else:
        w = m.to(feat.dtype)
        cnt = w.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (feat * w).sum(dim=1, keepdim=True) / cnt
        var = (((feat - mean) ** 2) * w).sum(dim=1, keepdim=True) / (
            cnt - 1.0).clamp(min=1.0)
    g = _linear_relu(p, f"{pre}.agg.global_fc.0",
                     torch.cat([feat, var.expand_as(feat),
                                mean.expand_as(feat)], dim=-1))
    aw = _masked_softmax(_linear_relu(p, f"{pre}.agg.agg_w_fc.0", g), m, 1)
    agg = _linear_relu(p, f"{pre}.agg.fc.0", (g * aw).sum(dim=1))
    vox_img = torch.cat([vox, agg], dim=-1)                         # (P, 24)
    h = _linear_relu(p, f"{pre}.lr0.0", vox_img)
    sigma = F.softplus(F.linear(h, p[f"{pre}.sigma.0.weight"],
                                p[f"{pre}.sigma.0.bias"]))
    shared = torch.cat([h, vox_img], dim=-1)                        # (P, 88)
    # color.0 on [shared ‖ view] is W[:, :88]·shared + W[:, 88:]·view + b:
    # the shared part once a sample, the rest once a view
    w0, b0 = p[f"{pre}.color.0.weight"], p[f"{pre}.color.0.bias"]
    n_shared = shared.shape[-1]
    x = F.relu(F.linear(shared, w0[:, :n_shared])[:, None]
               + F.linear(views, w0[:, n_shared:], b0))
    cw = _masked_softmax(_linear_relu(p, f"{pre}.color.2", x), m, 1)
    color = (views[..., -7:-4] * cw).sum(dim=1)
    return torch.cat([color, sigma], dim=-1)


# --------------------------------------------------------------------------
# geometry


def _scale_k(K, s):
    K = K.clone()
    K[..., :2, :] = K[..., :2, :] * s
    return K


def proj_mats(src_exts, src_ixts, tar_ext, tar_ixt, src_scale, tar_scale):
    """(B, S, 4, 4) maps from the target volume's homogeneous (x·d, y·d, d,
    1) to source feature pixels (u·z, v·z, z, ·)."""
    def full(K, E):
        P = torch.zeros(E.shape, dtype=E.dtype, device=E.device)
        P[..., :3, :3] = K
        P[..., 3, 3] = 1.0
        return P @ E

    src = full(_scale_k(src_ixts, src_scale), src_exts)
    tar = full(_scale_k(tar_ixt, tar_scale), tar_ext)
    return src @ torch.linalg.inv(tar)[:, None]


def variance_volume(feat, P, depth, view_mask):
    """feat (B, S, C, h, w) source features, P (B, S, 4, 4), depth (B, D,
    Hv, Wv) planes → (B, C, D, Hv, Wv) variance over the valid views of the
    bilinearly warped features (zeros outside the source image)."""
    B, S, C, h, w = feat.shape
    D, Hv, Wv = depth.shape[1:]
    ys, xs = torch.meshgrid(torch.arange(Hv, dtype=depth.dtype, device=depth.device),
                            torch.arange(Wv, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    hom = torch.stack([xs * depth, ys * depth, depth,
                       torch.ones_like(depth)], dim=-1)            # (B, D, Hv, Wv, 4)
    pts = torch.einsum("bsij,bdyxj->bsdyxi", P, hom)
    z = pts[..., 2].clamp(min=1e-6)
    gx = pts[..., 0] / z / (w - 1) * 2 - 1
    gy = pts[..., 1] / z / (h - 1) * 2 - 1
    grid = torch.stack([gx, gy], dim=-1).reshape(B * S, D * Hv, Wv, 2)
    warped = F.grid_sample(feat.reshape(B * S, C, h, w), grid, mode="bilinear",
                           padding_mode="zeros", align_corners=True)
    warped = warped.reshape(B, S, C, D, Hv, Wv)
    m = view_mask.to(warped.dtype).view(B, S, 1, 1, 1, 1)
    cnt = m.sum(dim=1).clamp(min=1.0)
    mean = (warped * m).sum(dim=1) / cnt
    return (warped * warped * m).sum(dim=1) / cnt - mean * mean


def regress_depth(logits, planes, inv):
    """Softmax expectation and standard deviation over the D planes; in
    disparity when ``inv``."""
    prob = torch.softmax(logits, dim=1)
    v = 1.0 / planes.clamp(min=1e-6) if inv else planes
    depth = (prob * v).sum(dim=1)
    var = (prob * (v - depth[:, None]) ** 2).sum(dim=1)
    return depth, var.clamp(min=1e-10).sqrt()


def _up(x, size):
    """Align-corners bilinear resize of (B, [C,] h, w) to ``size``."""
    squeeze = x.dim() == 3
    y = F.interpolate(x[:, None] if squeeze else x, size=size, mode="bilinear",
                      align_corners=True)
    return y[:, 0] if squeeze else y


def first_planes(near_far, D, Hv, Wv, inv):
    """The first level's planes, uniform in disparity (``inv``) or depth
    between the scene's near and far, and their bounds (B, 2, Hv, Wv), in
    disparity when ``inv``."""
    lin = torch.linspace(0.0, 1.0, D, dtype=near_far.dtype, device=near_far.device)
    near, far = near_far[:, :1], near_far[:, 1:2]
    if inv:
        planes = 1.0 / (1.0 / near + lin * (1.0 / far - 1.0 / near))
    else:
        planes = near + lin * (far - near)
    planes = planes[:, :, None, None].expand(-1, -1, Hv, Wv)
    nf = planes[:, [0, D - 1]]
    return planes, (1.0 / nf.clamp(min=1e-6) if inv else nf)


def next_planes(depth, std, nf, D, inv_prev, inv_cur, size):
    """The next level's per-pixel planes in [depth − std, depth + std] of
    the previous level, clamped to its bounds, at ``size``."""
    depth, std, nf = _up(depth, size), _up(std, size), _up(nf, size)
    if inv_prev:
        near = 1.0 / torch.minimum(depth + std, nf[:, 0])
        far = 1.0 / torch.maximum(depth - std, nf[:, 1])
    else:
        near = torch.maximum(depth - std, nf[:, 0])
        far = torch.minimum(depth + std, nf[:, 1])
    lin = torch.linspace(0.0, 1.0, D, dtype=depth.dtype,
                         device=depth.device)[None, :, None, None]
    if inv_cur:
        planes = 1.0 / (1.0 / near[:, None] + lin * (1.0 / far[:, None]
                                                     - 1.0 / near[:, None]))
    else:
        planes = near[:, None] + lin * (far - near)[:, None]
    nf = planes[:, [0, D - 1]]
    return planes, (1.0 / nf.clamp(min=1e-6) if inv_cur else nf)


def _cam_center(E):
    return -torch.einsum("...ji,...j->...i", E[..., :3, :3], E[..., :3, 3])


def render_rays(p, cas, level, rays, depth, std, nf, feat_vol, img_table,
                src_exts, src_ixts, tar_ext, view_mask, H, W, chunk=65536):
    """Shade and composite the rays (N, 8) of one batch item at ``level``
    (render frame (H, W)): bounds from the level's depth pdf (B-less
    tensors of that item), samples, volume and image features, the IBR
    head, alpha compositing. Returns rgb (N, 3), depth (N,)."""
    up = (H, W)
    inv = cas["depth_inv"][level]
    d, s, nfu = _up(depth[None], up)[0], _up(std[None], up)[0], _up(nf[None], up)[0]
    if inv:
        r0, r1 = torch.minimum(d + s, nfu[0]), torch.maximum(d - s, nfu[1])
    else:
        r0, r1 = torch.maximum(d - s, nfu[0]), torch.minimum(d + s, nfu[1])
    px, py = rays[:, 6].long(), rays[:, 7].long()
    near, far = r0[py, px], r1[py, px]
    vnear, vfar = nfu[0][py, px], nfu[1][py, px]
    n = cas["num_samples"][level]
    lin = torch.linspace(0.0, 1.0, n, dtype=rays.dtype, device=rays.device)
    z = near[:, None] + (far - near)[:, None] * lin if n > 1 else (
        (near + (far - near) * 0.5)[:, None])
    t = 1.0 / z.clamp(min=1e-6) if inv else z
    xyz = rays[:, None, :3] + rays[:, None, 3:6] * t[..., None]      # (N, n, 3)
    if inv:
        dn = (vnear[:, None] - z) / (vnear - vfar).clamp(min=1e-6)[:, None]
    else:
        dn = (z - vnear[:, None]) / (vfar - vnear).clamp(min=1e-6)[:, None]
    # trilinear volume features, zeros outside: bilinear in (u, v) on every
    # plane, then the hat weights max(0, 1 − |z − k|) over the planes k
    Cv, D = feat_vol.shape[:2]
    u = rays[:, 6] / (W - 1) * 2 - 1
    v = rays[:, 7] / (H - 1) * 2 - 1
    planes = F.grid_sample(feat_vol.reshape(1, Cv * D, *feat_vol.shape[2:]),
                           torch.stack([u, v], dim=-1)[None, None],
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True)[0, :, 0].reshape(Cv, D, -1)
    ks = torch.arange(D, dtype=dn.dtype, device=dn.device)
    hat = (1.0 - (dn[..., None] * (D - 1) - ks).abs()).clamp(min=0.0)  # (N, n, D)
    vox = torch.einsum("rsd,cdr->rsc", hat, planes).reshape(-1, Cv)   # (N·n, 8)
    pts = xyz.reshape(-1, 3)
    S, C, Ht, Wt = img_table.shape
    K = _scale_k(src_ixts, cas["render_scale"][level])
    cam = torch.einsum("sij,pj->psi", src_exts[:, :3, :3], pts) + src_exts[:, :3, 3]
    img = torch.einsum("sij,psj->psi", K, cam)
    zz = img[..., 2:].clamp(min=1e-6)
    g = torch.stack([img[..., 0:1] / zz / (Wt - 1) * 2 - 1,
                     img[..., 1:2] / zz / (Ht - 1) * 2 - 1], dim=-1)[..., 0, :]
    feat = F.grid_sample(img_table, g.permute(1, 0, 2)[:, None], mode="bilinear",
                         padding_mode="border", align_corners=True)[:, :, 0]
    feat = feat.permute(2, 0, 1)                                     # (P, S, C)
    tdir = pts - _cam_center(tar_ext)
    tdir = tdir / (tdir.norm(dim=-1, keepdim=True) + 1e-6)
    sdir = pts[:, None] - _cam_center(src_exts)
    sdir = sdir / (sdir.norm(dim=-1, keepdim=True) + 1e-6)
    diff = tdir[:, None] - sdir
    ddir = diff / diff.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    dot = (tdir[:, None] * sdir).sum(dim=-1, keepdim=True)
    views = torch.cat([feat, ddir, dot], dim=-1)
    mask = view_mask > 0
    raw = torch.cat([ibr_head(p, level, vox[i:i + chunk], views[i:i + chunk], mask)
                     for i in range(0, vox.shape[0], chunk)])
    raw = raw.reshape(-1, n, 4)
    alpha = 1.0 - torch.exp(-raw[..., 3])
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans
    rgb = (w[..., None] * raw[..., :3]).sum(dim=1)
    dep = (torch.softmax(w, dim=-1) * z.detach()).sum(dim=-1)
    return rgb, dep


def forward(p: Params, stats: Params, cas: dict, batch: Dict[str, torch.Tensor],
            train: bool = False, mask_rays: bool = False
            ) -> Dict[str, torch.Tensor]:
    """The cascade on ``batch`` (device tensors: src_inps, src_exts,
    src_ixts, tar_ext, tar_ixt, near_far, view_mask, rays_{i}; with
    ``mask_rays`` also mask_at_box (B, N), whose rays alone the last level
    renders, the others left 0). Returns {rgb, depth, depth_mvs,
    std}_level{i} of every rendered level."""
    src = batch["src_inps"]
    B, S, H0, W0, _ = src.shape
    feats = feature_net(p, stats, src.reshape(B * S, H0, W0, 3).permute(0, 3, 1, 2),
                        train)
    view_mask = batch.get("view_mask")
    if view_mask is None:
        view_mask = torch.ones(B, S, dtype=src.dtype, device=src.device)
    out = {}
    depth = std = nf = None
    for i in range(cas["num"]):
        vs = cas["volume_scale"][i]
        Hv, Wv = int(math.floor(H0 * vs)), int(math.floor(W0 * vs))
        D = cas["volume_planes"][i]
        if depth is None:
            planes, nf = first_planes(batch["near_far"], D, Hv, Wv,
                                      cas["depth_inv"][i])
        else:
            planes, nf = next_planes(depth, std, nf, D, cas["depth_inv"][i - 1],
                                     cas["depth_inv"][i], (Hv, Wv))
        P = proj_mats(batch["src_exts"], batch["src_ixts"], batch["tar_ext"],
                      batch["tar_ixt"], cas["im_feat_scale"][i], vs)
        f = feats[i]
        vol = variance_volume(f.reshape(B, S, *f.shape[1:]), P, planes, view_mask)
        fvol, logits = cost_reg(p, stats, i, i == cas["num"] - 1, vol, train)
        depth, std = regress_depth(logits, planes, cas["depth_inv"][i])
        if not cas["render_if"][i]:
            continue
        rs = cas["render_scale"][i]
        H, W = int(H0 * rs), int(W0 * rs)
        im = feats[cas["render_im_feat_level"][i]]
        up = rs / cas["im_ibr_scale"][i]
        if up != 1.0:
            im = _up(im, (int(math.floor(im.shape[-2] * up)),
                          int(math.floor(im.shape[-1] * up))))
        rgb_src = (src * 0.5 + 0.5).reshape(B * S, H0, W0, 3).permute(0, 3, 1, 2)
        if rs != 1.0:
            rgb_src = _up(rgb_src, (H, W))
        table = torch.cat([im, rgb_src], dim=1).reshape(B, S, -1, H, W)
        rgbs, deps = [], []
        for b in range(B):
            rays = batch[f"rays_{i}"][b]
            keep = None
            if mask_rays and i == cas["num"] - 1:
                keep = torch.nonzero(batch["mask_at_box"][b] > 0)[:, 0]
                rays = rays[keep]
            rgb, dep = render_rays(p, cas, i, rays, depth[b], std[b], nf[b],
                                   fvol[b], table[b], batch["src_exts"][b],
                                   batch["src_ixts"][b], batch["tar_ext"][b],
                                   view_mask[b], H, W)
            if keep is not None:
                n_all = batch[f"rays_{i}"].shape[1]
                rgb = rgb.new_zeros(n_all, 3).index_copy(0, keep, rgb)
                dep = dep.new_zeros(n_all).index_copy(0, keep, dep)
            rgbs.append(rgb)
            deps.append(dep)
        out[f"rgb_level{i}"] = torch.stack(rgbs)
        out[f"depth_level{i}"] = torch.stack(deps)
        out[f"depth_mvs_level{i}"] = 1.0 / depth if cas["depth_inv"][i] else depth
        out[f"std_level{i}"] = std
    return out


# --------------------------------------------------------------------------
# training


def split_state(state: Params, dtype=torch.float32) -> Tuple[Params, Params]:
    """(learned parameters, BN buffers) of a state dict, each a fresh copy
    in ``dtype``; the parameters require a gradient."""
    params, stats = {}, {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            stats[k] = v.detach().clone()
        elif k.endswith(("running_mean", "running_var")):
            stats[k] = v.detach().clone().to(dtype)
        else:
            params[k] = v.detach().clone().to(dtype).requires_grad_(True)
    return params, stats


def loss_fn(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            cas: dict, keep: Optional[float] = None) -> torch.Tensor:
    """Σ over rendered levels of loss_weight × MSE(rgb, target rgb);
    ``keep`` restricts the mean to that leading share of each level's
    rays."""
    loss = 0.0
    for i in range(cas["num"]):
        if cas["render_if"][i]:
            pred, gt = out[f"rgb_level{i}"], batch[f"rgb_{i}"]
            if keep is not None:
                n = int(pred.shape[1] * keep)
                pred, gt = pred[:, :n], gt[:, :n]
            loss = loss + cas["loss_weight"][i] * torch.mean((pred - gt) ** 2)
    return loss


def train_steps(state: Params, cas: dict, opt: dict,
                batches: Sequence[Dict[str, torch.Tensor]],
                keep: Optional[float] = None, frozen: bool = False,
                dtype=torch.float32):
    """Adam steps of the MSE loss from ``state`` (the published state dict)
    on ``batches``, one a step: the gradient clipped by value
    (``opt['grad_clip_value']``), Adam with ``opt``'s lr, betas (0.9,
    0.999), eps and weight decay, the lr scaled by the exponential
    schedule γ^((step // ep_iter) / decay_epochs). ``keep`` and ``frozen``
    plant faults: the loss over a share of the rays only, or no update.
    ``dtype`` is the parameters' type (the batches come in theirs).

    Returns (losses [float], first gradients {key: tensor} as the optimizer
    takes them (clipped), parameters after the steps {key: tensor}, the
    BatchNorm running means and variances after the first step {key:
    tensor})."""
    params, stats = split_state(state, dtype)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = 0.9, 0.999
    losses, first = [], None
    sched = opt["scheduler"]
    for t, batch in enumerate(batches):
        out = forward(params, stats, cas, batch, train=True)
        loss = loss_fn(out, batch, cas, keep)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        lr = opt["lr"] * sched["gamma"] ** ((t // opt["ep_iter"]) / sched["decay_epochs"])
        with torch.no_grad():
            g_all = {}
            for (k, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                g = g.clamp(-opt["grad_clip_value"], opt["grad_clip_value"])
                if opt["weight_decay"]:
                    g = g + opt["weight_decay"] * p
                g_all[k] = g
                if frozen:
                    continue
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
                denom = v2[k].sqrt() / math.sqrt(c2) + opt["eps"]
                p.addcdiv_(m[k], denom, value=-lr / c1)
            if first is None:
                first = g_all
                first_stats = {k: v.clone() for k, v in stats.items()
                               if k.endswith(("running_mean", "running_var"))}
    return losses, first, {k: p.detach() for k, p in params.items()}, first_stats
