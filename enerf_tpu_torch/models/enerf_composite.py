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

The heads read no volume feature (``use_vox_feat=False``), so the fg
feature volume is never padded back or sampled. The JAX package runs them
raw on differentiable XLA, not on a Pallas kernel; so does this model in
training and wherever ``layer_render.takes`` refuses a level. In eval with
one fg layer and one sample a layer (ENeRF-Outdoor's level 1),
``layer_render`` shades both layers and composites them in one CUDA
kernel (``csrc/layer_render.cu``) on the card, from each layer's features
and rgb, with no image table, paste or concatenation. The cost volumes
(K1) and depth regression (K4) run their CUDA kernels in eval.

``dtype`` is the compute type, as ``ENeRF``'s (the bf16 mode: FPNs and 3D
CNNs in bf16, K1's bf16 variant, K4's mixed one, the layered render's bf16
feature variant; the heads in f32, as the JAX package's packed head runs,
``enerf_tpu/models/enerf_composite.py:170-207``; in training the image
table rounded to bf16).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from enerf_tpu_torch.config import ENeRFConfig
from enerf_tpu_torch.models.cost_reg import MinCostRegNet
from enerf_tpu_torch.models.enerf import (
    FEAT_CH,
    fpn_features,
    image_features,
    image_tables,
)
from enerf_tpu_torch.models.feature_net import FeatureNet
from enerf_tpu_torch.models.layers import init_weights
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.camera import get_proj_mats
from enerf_tpu_torch.ops.composite import composite_layers
from enerf_tpu_torch.ops.depth import (
    cascade_depth_values,
    depth_regression,
    init_depth_values,
)
from enerf_tpu_torch.ops.kernels import layer_render as klr
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
        and ``fg_render_{i}`` (the rays, the window crop, the samples), then
        ``bg_{i}`` holding ``bg_cost_volume_{i}``, ``bg_cost_reg_{i}`` and
        ``bg_render_{i}`` (the rays, the samples), then ``composite_{i}``);
        ``stage_hook(name)``, when given, is called as each closes, right
        after the stage is enqueued.

        A rendered level whose layers ``layer_render.takes`` (in eval: one
        fg layer, one sample a layer) is shaded and composited in
        ``composite_{i}`` by ``layer_render`` (the kernel on the card).
        Otherwise each layer's raw head runs in its render span, the fg
        output is pasted into the frame there, and ``composite_{i}`` runs
        ``composite_layers``."""
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
            fused = (cas.render_if[i] and not self.training and klr.takes(
                [getattr(self, f"nerf_{i}_layer{l}") for l in range(L)],
                getattr(self, f"nerf_{i}_bg"), cas.num_samples[i],
                feats[f"level_{cas.render_im_feat_level[i]}"],
                feats_bg[f"level_{cas.render_im_feat_level[i]}"],
                batch["src_inps"], batch["bg_src_inps"]))
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
                        rays = win.crop(rays.reshape(B, Hr, Wr, -1)).reshape(
                            B, hr * wr, -1)
                        head = getattr(self, f"nerf_{i}_layer{l}")
                        if fused:
                            fg_layer = self._layer(i, rays, feats,
                                                   batch["src_inps"], head)
                        else:
                            out = self.render_raw(i, rays, feats,
                                                  batch["src_inps"], head,
                                                  batch, view_mask)
                            # into the full frame (parse_layer,
                            # utils.py:875-887)
                            layers.append({
                                k: win.paste(
                                    v.reshape((B, hr, wr) + v.shape[2:])
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
                        head = getattr(self, f"nerf_{i}_bg")
                        if fused:
                            bg_layer = self._layer(i, rays, feats_bg,
                                                   batch["bg_src_inps"], head)
                        else:
                            layers.append(self.render_raw(
                                i, rays, feats_bg, batch["bg_src_inps"], head,
                                batch, view_mask))
            if not cas.render_if[i]:
                continue
            with span(f"composite_{i}", stage_hook):
                if fused:
                    ret_i = klr.layer_render(
                        fg_layer, bg_layer, win, batch["src_exts"],
                        batch["src_ixts"], batch["tar_ext"], view_mask,
                        render_scale=rs, white_bkgd=self.cfg.white_bkgd)
                else:
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

    def _samples(self, level, rays):
        """A layer's samples of its rays (B, N, 12): world_xyz (B, N, n, 3)
        and z_vals (B, N, n) as composited, as depth (1/z on a disparity
        level)."""
        cas = self.cfg.cas_config
        world_xyz, _, z_vals = sample_along_depth(
            rays, n_samples=cas.num_samples[level],
            depth_inv=cas.depth_inv[level])
        if cas.depth_inv[level]:
            z_vals = 1.0 / torch.clamp(z_vals, min=1e-6)
        return world_xyz, z_vals

    def _layer(self, level, rays, feats, src_inps, head) -> klr.Layer:
        """A layer's samples and what shades them, for ``layer_render``."""
        return klr.Layer(*self._samples(level, rays),
                         *image_tables(self.cfg.cas_config, level, feats,
                                       src_inps), head)

    def render_raw(self, level, rays, feats, src_inps, head, batch, view_mask
                   ) -> Dict[str, torch.Tensor]:
        """One layer's raw samples, not composited (reference
        network_composite.py:28-51): ``net_output`` (B, N, n, 4) = rgb ‖
        sigma and ``z_vals`` (B, N, n), as depth (1/z on a disparity
        level)."""
        cas = self.cfg.cas_config
        world_xyz, z_vals = self._samples(level, rays)
        raw = klr.shade_raw(
            world_xyz, image_features(cas, level, feats, src_inps), head,
            batch["src_exts"], batch["src_ixts"], batch["tar_ext"], view_mask,
            cas.render_scale[level],
            table_bf16=self.training and self.dtype == torch.bfloat16)
        return {"net_output": raw, "z_vals": z_vals}

