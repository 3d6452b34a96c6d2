"""The work of a composite frame (ENeRF-Outdoor's model), counted from its
shapes once, as the algorithm needs it, whatever implements it; FLOPs are
twice the multiply-adds, bytes float32, one frame (batch 1):

- ``frame_flops``: both FPNs on the source views, each layer's
  MinCostRegNet at each level (an fg layer's on its window's volume, the
  background's on the frame's) and each rendered layer's head on its
  rays (for ``mfu.render``);
- ``cost_volume_bytes``: K1's footprint over the levels and layers, as
  ``work.cost_volume_bytes`` counts a frame's: a full-frame volume reads
  each valid view's features whole; a window's reads, of each view, a
  region of the window's size at the features' scale (the performer is
  seen at about the same size in every view), and both write the volume
  and read its planes once;
- ``layer_render_flops`` and ``layer_render_bytes``: the heads without a
  volume feature and the layers' compositing at the last rendered level
  (``layer_render_roofline``, whose stages are that level's): each
  layer's head on its rays' samples (``head_macs``), 4 multiply-adds a
  sample to composite (weight × rgb, weight × z); each layer's image
  table read once (every view's features ‖ rgb at render scale: the
  background's whole, an fg layer's a region of its window's size, as
  ``cost_volume_bytes`` counts its features), its rays (8 values), its
  depth, std and near / far at volume scale (an fg layer's over its
  window), and the composite's rgb, depth and weights written once.
"""

from __future__ import annotations

from typing import Dict, List

from benchmark.reference import enerf_composite as rc
from benchmark.work import (COMPOSITE_MACS, F32_BYTES, cost_reg_convs, fpn_convs,
                            level_shapes)


def head_macs(feat_ch: int, viewdir_agg: bool):
    """(multiply-adds a view, a sample) of the head without a volume
    feature: per view view_fc (when ``viewdir_agg``), global_fc, agg_w_fc,
    color.0's view inputs and color.2; per sample fc, lr0, sigma and
    color.0's 80 shared inputs."""
    lay = {n: (i, o) for n, i, o in rc.head_layers(feat_ch, viewdir_agg)}
    per_view = sum(i * o for n, (i, o) in lay.items()
                   if n in ("agg.view_fc.0", "agg.global_fc.0", "agg.agg_w_fc.0",
                            "color.2"))
    c_in, c_out = lay["color.0"]
    per_view += (feat_ch + 4) * c_out
    per_sample = sum(i * o for n, (i, o) in lay.items()
                     if n in ("agg.fc.0", "lr0.0", "sigma.0"))
    per_sample += (c_in - feat_ch - 4) * c_out
    return per_view, per_sample


def layers(cfg: dict, cas: dict, H0: int, W0: int) -> List[Dict]:
    """Per level and layer (fg layers, then bg): its planes, its volume's
    (h, w), its rendered rays at render scale (0 if the level is not
    rendered) and the level's shapes (``work.level_shapes``)."""
    fg_h, fg_w = cfg["enerf"]["fg_bbox_hw"]
    L = cfg["enerf"]["num_fg_layers"]
    out = []
    for i, sh in enumerate(level_shapes(cas, H0, W0)):
        vs, rs = cas["volume_scale"][i], cas["render_scale"][i]
        for name in rc.layer_names(L):
            fg = name != "bg"
            out.append({
                "level": i, "fg": fg, "sh": sh,
                "D": sh["D"] if fg else cfg["enerf"]["bg_volume_planes"][i],
                "hv": int(fg_h * vs) if fg else sh["Hv"],
                "wv": int(fg_w * vs) if fg else sh["Wv"],
                "rays": (int(fg_h * rs) * int(fg_w * rs) if fg else sh["H"] * sh["W"])
                if cas["render_if"][i] else 0})
    return out


def frame_flops(cfg: dict, cas: dict, H0: int, W0: int, S: int) -> float:
    macs = 2 * S * sum(m for _, m in fpn_convs(H0, W0))
    viewdir = cfg["enerf"]["viewdir_agg"]
    for lay in layers(cfg, cas, H0, W0):
        macs += sum(m for _, m in cost_reg_convs(lay["level"], lay["D"], lay["hv"],
                                                 lay["wv"], False))
        pv, ps = head_macs(lay["sh"]["feat_ch"], viewdir)
        macs += (S * pv + ps) * lay["sh"]["n"] * lay["rays"]
    return 2.0 * macs


def cost_volume_bytes(cfg: dict, cas: dict, H0: int, W0: int, S: int) -> float:
    fg_h, fg_w = cfg["enerf"]["fg_bbox_hw"]
    total = 0.0
    for lay in layers(cfg, cas, H0, W0):
        sh = lay["sh"]
        fs = cas["im_feat_scale"][lay["level"]]
        feat_px = (int(fg_h * fs) * int(fg_w * fs)) if lay["fg"] else sh["Hs"] * sh["Ws"]
        vox = lay["D"] * lay["hv"] * lay["wv"]
        total += F32_BYTES * (S * feat_px * sh["C"] + vox * sh["C"] + vox + S * 12 + S)
    return total


def _last(cas: dict) -> int:
    return max(i for i in range(cas["num"]) if cas["render_if"][i])


def layer_render_flops(cfg: dict, cas: dict, H0: int, W0: int, S: int) -> float:
    viewdir = cfg["enerf"]["viewdir_agg"]
    macs = 0
    for lay in layers(cfg, cas, H0, W0):
        if lay["level"] != _last(cas):
            continue
        pv, ps = head_macs(lay["sh"]["feat_ch"], viewdir)
        macs += (S * pv + ps + COMPOSITE_MACS) * lay["sh"]["n"] * lay["rays"]
    return 2.0 * macs


def layer_render_bytes(cfg: dict, cas: dict, H0: int, W0: int, S: int) -> float:
    fg_h, fg_w = cfg["enerf"]["fg_bbox_hw"]
    rs = cas["render_scale"][_last(cas)]
    total, samples = 0.0, 0
    for lay in layers(cfg, cas, H0, W0):
        if lay["level"] != _last(cas):
            continue
        sh = lay["sh"]
        table_px = int(fg_h * rs) * int(fg_w * rs) if lay["fg"] else sh["H"] * sh["W"]
        total += F32_BYTES * (S * table_px * sh["feat_ch"] + 8 * lay["rays"]
                              + 4 * lay["hv"] * lay["wv"])
        samples += sh["n"]
    sh = level_shapes(cas, H0, W0)[_last(cas)]
    return total + F32_BYTES * sh["H"] * sh["W"] * (3 + 1 + samples)


def stages(cas: dict) -> Dict[str, List[str]]:
    """The composite's stage names the readers sum."""
    levels = range(cas["num"])
    last = _last(cas)
    return {"cost_volume_stages": [f"{k}_cost_volume_{i}" for i in levels
                                   for k in ("fg", "bg")],
            "cost_reg_stages": [f"{k}_cost_reg_{i}" for i in levels
                                for k in ("fg", "bg")],
            "layer_render_stages": [f"fg_render_{last}", f"bg_render_{last}",
                                    f"composite_{last}"]}
