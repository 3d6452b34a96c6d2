"""Compositional ENeRF for layered fg/bg scenes (the ENeRF-Outdoor model);
counterpart of ``enerf_tpu/models/enerf_composite.py`` (reference
``lib/networks/enerf/network_composite.py``).

Two FeatureNets, ``feature_net`` and ``feature_net_bg``, both on the
source images. Per cascade level and per fg layer l: the cost volume of a
fixed-size window (``fg_bbox_hw`` at volume scale) at the layer's
``bbox`` origin (K1's crop mode), its own MinCostRegNet
(``cost_reg_{i}_layer{l}``), the depth logits padded back to the full frame
with zeros for depth regression, the rays cut to the window at render
scale, and the raw head output (``nerf_{i}_layer{l}``) scattered into the
full frame. A background volume over the full frame with
``bg_volume_planes`` (``cost_reg_{i}_bg``, ``nerf_{i}_bg``, shaded from
``bg_src_inps``) follows; all layers' samples are then composited
(``composite_layers``).

Every window's origin stays on the card (``ops/window.py``): the bbox,
float32 in the batch, is scaled and truncated as the JAX package's
``(bbox * scale).astype(int32)``, and clamped into the frame as its
``dynamic_slice`` / ``dynamic_update_slice`` are. The whole forward is
batch-native.

The render stage is the heads' plain raw output (``use_vox_feat=False``:
the head reads no volume feature, so the fg feature volume is never padded
back or sampled) — as the JAX package runs it, on differentiable XLA and
not on a Pallas kernel. The cost volumes (K1) and depth regression (K4)
run their CUDA kernels in eval.

``dtype`` is the compute type, as ``ENeRF``'s (the bf16 mode: FPNs and 3D
CNNs in bf16, K1's bf16 variant, K4's mixed one; the heads in f32, as the
JAX package's packed head runs, ``enerf_tpu/models/enerf_composite.py:
170-207``; in training the image table rounded to bf16).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from enerf_tpu_torch.config import ENeRFConfig
from enerf_tpu_torch.models.cost_reg import MinCostRegNet
from enerf_tpu_torch.models.enerf import FEAT_CH, fpn_features, image_features
from enerf_tpu_torch.models.feature_net import FeatureNet
from enerf_tpu_torch.models.layers import init_weights
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.camera import get_proj_mats
from enerf_tpu_torch.ops.composite import exclusive_cumprod
from enerf_tpu_torch.ops.depth import (
    cascade_depth_values,
    depth_regression,
    init_depth_values,
)
from enerf_tpu_torch.ops.ibr import get_img_feat
from enerf_tpu_torch.ops.kernels.cost_volume import cost_volume_plain
from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth
from enerf_tpu_torch.ops.sampling import scale_size
from enerf_tpu_torch.ops.warp import build_cost_volume, build_cost_volume_crop
from enerf_tpu_torch.ops.window import Window
from enerf_tpu_torch.utils.profiling import span

StageHook = Optional[Callable[[str], None]]


class ENeRFComposite(nn.Module):
    def __init__(self, cfg: ENeRFConfig,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        cas = cfg.cas_config
        self.feature_net = FeatureNet(dtype)
        self.feature_net_bg = FeatureNet(dtype)
        heads = []
        for i in range(cas.num):
            # every level regularizes with MinCostRegNet
            # (network_composite.py:17,23)
            names = [f"layer{l}" for l in range(cfg.num_fg_layers)] + ["bg"]
            for name in names:
                self.add_module(f"cost_reg_{i}_{name}",
                                MinCostRegNet(FEAT_CH[i], dtype))
                head = NeRFHead(feat_ch=cas.nerf_model_feat_ch[i] + 3,
                                viewdir_agg=cfg.viewdir_agg,
                                use_vox_feat=False)
                self.add_module(f"nerf_{i}_{name}", head)
                heads.append(head)
        init_weights(self, generator)
        for head in heads:
            init_weights(head, generator, kaiming_linear=True)

    def forward(self, batch: Dict[str, torch.Tensor],
                stage_hook: StageHook = None) -> Dict[str, torch.Tensor]:
        """The composite forward, one span a stage
        (``utils/profiling.span``: ``feature_net``, then per level ``fg_{i}``
        holding each fg layer's ``fg_cost_volume_{i}`` (the projections,
        the planes, K1), ``fg_cost_reg_{i}`` (MinCostRegNet, the paste, K4)
        and ``fg_render_{i}`` (the rays, the window crop, the raw head, the
        paste), then ``bg_{i}`` holding ``bg_cost_volume_{i}``,
        ``bg_cost_reg_{i}`` and ``bg_render_{i}``, then ``composite_{i}``);
        ``stage_hook(name)``, when given, is called as each closes, right
        after the stage is enqueued."""
        cas = self.cfg.cas_config
        L = self.cfg.num_fg_layers
        with span("feature_net", stage_hook):
            feats = fpn_features(self.feature_net, batch["src_inps"])
            feats_bg = fpn_features(self.feature_net_bg, batch["src_inps"])
        view_mask = batch.get("view_mask")
        H_O, W_O = batch["src_inps"].shape[2:4]
        bbox = batch["bbox"].to(torch.float32)    # (B, L, 4) x, y, w, h
        fg_h, fg_w = self.cfg.fg_bbox_hw

        ret: Dict[str, torch.Tensor] = {}
        fg_prev: List = [None] * L                 # (depth, std, near_far)
        bg_prev = None
        for i in range(cas.num):
            vs, rs = cas.volume_scale[i], cas.render_scale[i]
            Hv, Wv = scale_size(H_O, vs), scale_size(W_O, vs)
            Hr, Wr = scale_size(H_O, rs), scale_size(W_O, rs)
            projs = None
            with span(f"fg_{i}", stage_hook):
                layers = []
                for l in range(L):
                    with span(f"fg_cost_volume_{i}", stage_hook):
                        if projs is None:
                            projs = self._projs(i, batch)
                        depth_values, near_far = self._planes(
                            i, fg_prev[l], batch["near_far"][:, l],
                            cas.volume_planes[i], Hv, Wv)
                        hv, wv = int(fg_h * vs), int(fg_w * vs)
                        xy0 = (bbox[:, l, :2] * vs).to(torch.int32)
                        if self.training:
                            volume = cost_volume_plain(
                                feats[f"level_{i}"], projs, depth_values,
                                view_mask, window=(xy0, (hv, wv)))
                        else:
                            volume = build_cost_volume_crop(
                                feats[f"level_{i}"], projs, depth_values, xy0,
                                (hv, wv), view_mask)
                    with span(f"fg_cost_reg_{i}", stage_hook):
                        _, logits = getattr(self, f"cost_reg_{i}_layer{l}")(
                            volume)
                        # pad back to the full frame
                        # (network_composite.py:102-103)
                        logits = Window(xy0, (hv, wv), (Hv, Wv)).paste(
                            logits, planes=True)
                        depth, std = depth_regression(logits, depth_values,
                                                      cas.depth_inv[i])
                        fg_prev[l] = (depth, std, near_far)
                    if not cas.render_if[i]:
                        continue
                    with span(f"fg_render_{i}", stage_hook):
                        rays = build_rays(batch[f"rays_{i}"], depth, std,
                                          near_far,
                                          depth_inv=cas.depth_inv[i],
                                          up_scale=rs / vs)
                        # the rays of the window at render scale
                        # (build_rays_composite, utils.py:219-252)
                        hr, wr = int(fg_h * rs), int(fg_w * rs)
                        win = Window((bbox[:, l, :2] * rs).to(torch.int32),
                                     (hr, wr), (Hr, Wr))
                        B = rays.shape[0]
                        rays = win.crop(rays.reshape(B, Hr, Wr, -1))
                        out = self.render_raw(
                            i, rays.reshape(B, hr * wr, -1), feats,
                            batch["src_inps"],
                            getattr(self, f"nerf_{i}_layer{l}"), batch,
                            view_mask)
                        # into the full frame (parse_layer, utils.py:875-887)
                        layers.append({
                            k: win.paste(v.reshape((B, hr, wr) + v.shape[2:])
                                         ).reshape((B, Hr * Wr) + v.shape[2:])
                            for k, v in out.items()})

            # background (network_composite.py:120-139)
            with span(f"bg_{i}", stage_hook):
                with span(f"bg_cost_volume_{i}", stage_hook):
                    if projs is None:
                        projs = self._projs(i, batch)
                    depth_values, nf_bg = self._planes(
                        i, bg_prev, batch["near_far"][:, -1],
                        self.cfg.bg_volume_planes[i], Hv, Wv)
                    volume = (cost_volume_plain if self.training
                              else build_cost_volume)(
                        feats_bg[f"level_{i}"], projs, depth_values, view_mask)
                with span(f"bg_cost_reg_{i}", stage_hook):
                    _, logits = getattr(self, f"cost_reg_{i}_bg")(volume)
                    depth, std = depth_regression(logits, depth_values,
                                                  cas.depth_inv[i])
                    bg_prev = (depth, std, nf_bg)
                if cas.render_if[i]:
                    with span(f"bg_render_{i}", stage_hook):
                        rays = build_rays(batch[f"rays_{i}"], depth, std,
                                          nf_bg, depth_inv=cas.depth_inv[i],
                                          up_scale=rs / vs)
                        layers.append(self.render_raw(
                            i, rays, feats_bg, batch["bg_src_inps"],
                            getattr(self, f"nerf_{i}_bg"), batch, view_mask))
            if not cas.render_if[i]:
                continue
            with span(f"composite_{i}", stage_hook):
                ret_i = composite_layers(layers, num_fg_layers=L,
                                         white_bkgd=self.cfg.white_bkgd)
                ret.update({f"{k}_level{i}": v for k, v in ret_i.items()})
        return ret

    def _projs(self, level, batch):
        """The level's projections from the target volume to the source
        features (one set for every layer)."""
        cas = self.cfg.cas_config
        return get_proj_mats(batch["src_exts"], batch["src_ixts"],
                             batch["tar_ext"], batch["tar_ixt"],
                             src_scale=cas.im_feat_scale[level],
                             tar_scale=cas.volume_scale[level])

    def _planes(self, level, prev, near_far, D, Hv, Wv):
        """A layer's depth planes: from the scene's near/far at level 0,
        else from the layer's previous level ``prev`` = (depth, std,
        near_far)."""
        cas = self.cfg.cas_config
        if prev is None:
            return init_depth_values(near_far, D, Hv, Wv, cas.depth_inv[level])
        return cascade_depth_values(
            *prev, D, depth_inv_prev=cas.depth_inv[level - 1],
            depth_inv_cur=cas.depth_inv[level],
            up_scale=cas.volume_scale[level] / cas.volume_scale[level - 1])

    def render_raw(self, level, rays, feats, src_inps, head, batch, view_mask
                   ) -> Dict[str, torch.Tensor]:
        """One layer's raw samples, not composited (reference
        network_composite.py:28-51): ``net_output`` (B, N, n, 4) = rgb ‖
        sigma and ``z_vals`` (B, N, n), as depth (1/z on a disparity
        level)."""
        cas = self.cfg.cas_config
        world_xyz, _, z_vals = sample_along_depth(
            rays, n_samples=cas.num_samples[level],
            depth_inv=cas.depth_inv[level])
        B, N, n = world_xyz.shape[:3]
        img_feat_rgb_dir = get_img_feat(
            world_xyz, image_features(cas, level, feats, src_inps),
            batch["src_exts"], batch["src_ixts"], batch["tar_ext"],
            render_scale=cas.render_scale[level],
            table_bf16=self.training and self.dtype == torch.bfloat16)
        raw = head(None, img_feat_rgb_dir, view_mask).reshape(B, N, n, -1)
        if cas.depth_inv[level]:
            z_vals = 1.0 / torch.clamp(z_vals, min=1e-6)
        return {"net_output": raw, "z_vals": z_vals}


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
