"""The work of a cell, counted from its shapes once, as the algorithm needs
it, whatever implements it: the model's multiply-adds (for the ``mfu``
metrics), the cost volume's bytes (K1's footprint) and the IBR head's
and compositing's multiply-adds (K2's), and the table of the card's
peaks. Copies of the port's counts (``chip_smoke.py:k1_work``,
``k2_work``), with K2 counted once and not in its three TF32 passes, and
the features counted whole where ``k1_work`` counts the pixels the warp
touches.

Every count is of one frame (batch 1) or one train step; FLOPs are twice
the multiply-adds.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.reference.enerf import (COST_REG_FULL, COST_REG_MIN, FEAT_CH,
                                       FPN_LAYERS, head_layers)

# NVIDIA H100 SXM 80GB data sheet, dense rates, at its 700 W power limit.
# TF32 is the fastest published rate at which the card computes at f32
# accuracy by any route (the 3×TF32 split of the render kernel included),
# so it is the peak of the f32 configurations' mfu and render roofline.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "tf32_flops_per_s": 495e12,
         "f32_flops_per_s": 67e12, "bf16_flops_per_s": 989e12,
         "power_limit_w": 700.0}
F32_BYTES = 4


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def fpn_convs(H: int, W: int) -> List[Tuple[str, int]]:
    """(layer, multiply-adds) of the FPN on one (H, W) image, in the
    reference's order."""
    size = {"x": (H, W)}
    src = {"conv0.0": "x", "conv0.1": "conv0.0", "conv1.0": "conv0.1",
           "conv1.1": "conv1.0", "conv2.0": "conv1.1", "conv2.1": "conv2.0",
           "toplayer": "conv2.1", "lat1": "conv1.1", "lat0": "conv0.1",
           "smooth1": "conv1.1", "smooth0": "conv0.1"}
    out = []
    for name, _, cin, cout, k, s, p in FPN_LAYERS:
        h, w = size[src[name]]
        ho, wo = _out(h, k, s, p), _out(w, k, s, p)
        size[name] = (ho, wo)
        out.append((name, cin * cout * k * k * ho * wo))
    return out


def cost_reg_convs(level: int, D: int, H: int, W: int, full: bool
                   ) -> List[Tuple[str, int]]:
    """(layer, multiply-adds) of a level's 3D U-Net on a (D, H, W) volume;
    a transposed conv counts its input voxels × 27 × in × out."""
    out, size = [], (D, H, W)
    for name, kind, cin, cout, stride in (COST_REG_FULL if full else COST_REG_MIN):
        cin = FEAT_CH[level] if cin is None else cin
        if kind == "ctb":
            out.append((name, cin * cout * 27 * math.prod(size)))
            size = tuple(2 * n for n in size)
            continue
        if name == "feat_conv.0":
            size = (D, H, W)
        size = tuple(_out(n, 3, stride, 1) for n in size)
        out.append((name, cin * cout * 27 * math.prod(size)))
    return out


def head_macs(feat_ch: int, S: int) -> Tuple[int, int]:
    """(multiply-adds a view, a sample) of the IBR head: per view
    view_fc, global_fc, agg_w_fc, color.0's view inputs and color.2; per
    sample fc, lr0, sigma and color.0's 88 shared inputs."""
    lay = {n: (i, o) for n, i, o in head_layers(feat_ch)}
    per_view = sum(i * o for n, (i, o) in lay.items()
                   if n in ("agg.view_fc.0", "agg.global_fc.0", "agg.agg_w_fc.0",
                            "color.2"))
    c_in, c_out = lay["color.0"]
    per_view += (feat_ch + 4) * c_out
    per_sample = sum(i * o for n, (i, o) in lay.items()
                     if n in ("agg.fc.0", "lr0.0", "sigma.0"))
    per_sample += (c_in - feat_ch - 4) * c_out
    return per_view, per_sample


# compositing a sample: weight × rgb (3) and softmax(weights) × z (1)
COMPOSITE_MACS = 4


def level_shapes(cas: dict, H0: int, W0: int) -> List[dict]:
    out = []
    for i in range(cas["num"]):
        vs = cas["volume_scale"][i]
        rs = cas["render_scale"][i]
        fs = cas["im_feat_scale"][i]
        out.append({"D": cas["volume_planes"][i],
                    "Hv": int(math.floor(H0 * vs)), "Wv": int(math.floor(W0 * vs)),
                    "Hs": int(math.floor(H0 * fs)), "Ws": int(math.floor(W0 * fs)),
                    "C": FEAT_CH[i], "H": int(H0 * rs), "W": int(W0 * rs),
                    "n": cas["num_samples"][i],
                    "feat_ch": cas["nerf_model_feat_ch"][i] + 3})
    return out


def forward_layers(cas: dict, H0: int, W0: int, S: int,
                   rays: Dict[int, float]) -> List[Tuple[str, int]]:
    """(layer, multiply-adds) of one forward: the FPN on the S views, each
    level's 3D U-Net, and the head of each rendered level on ``rays[i]``
    rays (a mean where the rendered rays vary by frame)."""
    layers = [(f"feature_net.{n}", m * S) for n, m in fpn_convs(H0, W0)]
    for i, sh in enumerate(level_shapes(cas, H0, W0)):
        layers += [(f"cost_reg_{i}.{n}", m) for n, m in
                   cost_reg_convs(i, sh["D"], sh["Hv"], sh["Wv"],
                                  i == cas["num"] - 1)]
        if cas["render_if"][i]:
            pv, ps = head_macs(sh["feat_ch"], S)
            layers.append((f"nerf_{i}", int(round((S * pv + ps) * sh["n"] * rays[i]))))
    return layers


def frame_flops(cas: dict, H0: int, W0: int, S: int, rays: Dict[int, float]
                ) -> float:
    """FLOPs of one eval frame's convs and heads."""
    return 2.0 * sum(m for _, m in forward_layers(cas, H0, W0, S, rays))


def step_flops(cas: dict, H0: int, W0: int, S: int, rays: Dict[int, float]
               ) -> float:
    """FLOPs of one train step: the forward, then in the backward each
    conv's and Linear's input gradient and weight gradient (each as many
    multiply-adds as its forward), but the first conv's input gradient
    (the images need none)."""
    layers = forward_layers(cas, H0, W0, S, rays)
    fwd = sum(m for _, m in layers)
    first = layers[0][1]
    return 2.0 * (3 * fwd - first)


def cost_volume_bytes(cas: dict, H0: int, W0: int, S: int) -> float:
    """K1's footprint over the levels of a frame: each valid view's
    features read once, the depth planes read once, the variance volume
    written once, the projection matrices and view mask once."""
    total = 0.0
    for sh in level_shapes(cas, H0, W0):
        vox = sh["D"] * sh["Hv"] * sh["Wv"]
        total += F32_BYTES * (S * sh["Hs"] * sh["Ws"] * sh["C"] + vox * sh["C"]
                              + vox + S * 12 + S)
    return total


def render_flops(cas: dict, level: int, S: int, rays: float) -> float:
    """K2's FLOPs at ``level`` on ``rays`` rays: the head's multiply-adds
    once (``head_macs``) and the compositing's, two FLOPs each."""
    sh = level_shapes(cas, 1, 1)[level]
    pv, ps = head_macs(sh["feat_ch"], S)
    return 2.0 * (S * pv + ps + COMPOSITE_MACS) * cas["num_samples"][level] * rays
