"""Cascade ENeRF network; counterpart of ``enerf_tpu/models/enerf.py``
(``ENeRF.__call__``, eval and train mode).

Per cascade level: variance cost volume (plane sweep over the source
features; CUDA kernel ``ops/kernels/cost_volume.py``) → 3D CNN → softmax
depth regression (CUDA kernel ``ops/kernels/depth_regression.py``) →
depth-guided rays with n samples → IBR shading and alpha compositing (CUDA
kernel ``ops/kernels/render.py``). Padded source views carry
``view_mask = 0``. Module names follow the reference state dict
(``feature_net``, ``cost_reg_{i}``, ``nerf_{i}``).

In training mode (``model.train()``) the cost volume and the render stage
run their differentiable plain versions, as the JAX package trains on its
jnp ops and not on its eval-only kernels; depth regression keeps its
kernel, whose backward is the plain version's. BN normalizes by batch
statistics and updates its running statistics every forward. Grid rays
are used on a level when ``grid_rays`` and, in training, ``train_img``
of that level; otherwise the rays' bounds and volume features are
gathered at their pixels.

``dtype`` is the compute type (``compute_dtype``): float32, or bfloat16,
which runs the FPN and the 3D CNNs in bf16 (``models/layers.py:conv_bn``)
and gives K1 bf16 features, K4 bf16 logits with f32 plane values, and K2
a bf16 feature volume beside its f32 image table, head and outputs, as
the JAX package's bf16 mode does (``enerf_tpu/models/enerf.py``). The
parameters stay float32. In training the image table is rounded to bf16
before it is sampled (the JAX package's ``table_bf16``).

``ray_slice=(rank, world)`` renders one rank's share of a frame split over
the ranks of a data-parallel run (``train/step.py:
make_sharded_render_step``): the rank shades the contiguous rank-th of
world equal parts of each rendered level's rays (as gathered rays, which
the render kernel takes as grid rays are taken) and leaves zeros in the
per-ray outputs ``RAY_OUTPUTS`` of every other ray.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from enerf_tpu_torch.config import ENeRFConfig
from enerf_tpu_torch.models.cost_reg import CostRegNet, MinCostRegNet
from enerf_tpu_torch.models.feature_net import FeatureNet
from enerf_tpu_torch.models.layers import init_weights
from enerf_tpu_torch.models.nerf_head import NeRFHead
from enerf_tpu_torch.ops.camera import get_proj_mats
from enerf_tpu_torch.ops.depth import (
    cascade_depth_values,
    depth_regression,
    init_depth_values,
)
from enerf_tpu_torch.ops.ibr import unpreprocess
from enerf_tpu_torch.ops.kernels.cost_volume import cost_volume_plain
from enerf_tpu_torch.ops.kernels.render import render_rays, render_rays_plain
from enerf_tpu_torch.ops.rays import build_rays, sample_along_depth
from enerf_tpu_torch.ops.sampling import resize_bilinear, scale_size
from enerf_tpu_torch.ops.warp import build_cost_volume
from enerf_tpu_torch.parallel.dist import local_batch_slice
from enerf_tpu_torch.utils.profiling import span

# FPN output channels by feature level (level_0 = 1/4 res, level_2 = full)
FEAT_CH = {0: 32, 1: 16, 2: 8}

StageHook = Optional[Callable[[str], None]]
# (rank, world): this rank's share of every rendered level's rays
RaySlice = Optional[Tuple[int, int]]
# the outputs of ``render_level``, one value (or row) a ray
RAY_OUTPUTS = ("rgb", "depth", "weights")


class ENeRF(nn.Module):
    def __init__(self, cfg: ENeRFConfig,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        cas = cfg.cas_config
        self.feature_net = FeatureNet(dtype)
        for i in range(cas.num):
            reg_cls = MinCostRegNet if i == 0 else CostRegNet
            self.add_module(f"cost_reg_{i}", reg_cls(FEAT_CH[i], dtype))
            self.add_module(f"nerf_{i}", NeRFHead(
                feat_ch=cas.nerf_model_feat_ch[i] + 3,
                viewdir_agg=cfg.viewdir_agg))
        init_weights(self, generator)
        for i in range(cas.num):
            init_weights(getattr(self, f"nerf_{i}"), generator,
                         kaiming_linear=True)

    def forward_feat(self, src_inps: torch.Tensor) -> Dict[str, torch.Tensor]:
        """FPN features for all source views, NHWC per level."""
        return fpn_features(self.feature_net, src_inps)

    def forward(self, batch: Dict[str, torch.Tensor],
                stage_hook: StageHook = None, ray_slice: RaySlice = None
                ) -> Dict[str, torch.Tensor]:
        """Forward of the whole cascade, one span a stage
        (``utils/profiling.span``: ``feature_net``, ``cost_volume_{i}``,
        ``cost_reg_{i}``, ``depth_{i}``, ``render_{i}``); ``stage_hook(name)``,
        when given, is called as each closes, right after the stage is
        enqueued. ``ray_slice``: see the module's docstring."""
        cas = self.cfg.cas_config
        with span("feature_net", stage_hook):
            feats = self.forward_feat(batch["src_inps"])
        view_mask = batch.get("view_mask")
        H_O, W_O = batch["src_inps"].shape[2:4]

        ret: Dict[str, torch.Tensor] = {}
        depth = std = near_far = None
        for i in range(cas.num):
            with span(f"cost_volume_{i}", stage_hook):
                D = cas.volume_planes[i]
                if depth is None:
                    depth_values, near_far = init_depth_values(
                        batch["near_far"], D,
                        scale_size(H_O, cas.volume_scale[i]),
                        scale_size(W_O, cas.volume_scale[i]), cas.depth_inv[i])
                else:
                    depth_values, near_far = cascade_depth_values(
                        depth, std, near_far, D,
                        depth_inv_prev=cas.depth_inv[i - 1],
                        depth_inv_cur=cas.depth_inv[i],
                        up_scale=(cas.volume_scale[i]
                                  / cas.volume_scale[i - 1]))
                projs = get_proj_mats(batch["src_exts"], batch["src_ixts"],
                                      batch["tar_ext"], batch["tar_ixt"],
                                      src_scale=cas.im_feat_scale[i],
                                      tar_scale=cas.volume_scale[i])
                cost_volume = (cost_volume_plain if self.training
                               else build_cost_volume)
                volume = cost_volume(feats[f"level_{i}"], projs, depth_values,
                                     view_mask)
            with span(f"cost_reg_{i}", stage_hook):
                feat_volume, depth_logits = getattr(
                    self, f"cost_reg_{i}")(volume)
            with span(f"depth_{i}", stage_hook):
                depth, std = depth_regression(depth_logits, depth_values,
                                              cas.depth_inv[i])
            if not cas.render_if[i]:
                continue
            with span(f"render_{i}", stage_hook):
                ret_i = self._render_stage(i, depth, std, near_far,
                                           feat_volume, feats, batch,
                                           view_mask, ray_slice=ray_slice)
            ret_i["depth_mvs"] = (1.0 / depth) if cas.depth_inv[i] else depth
            ret_i["std"] = std
            ret.update({f"{k}_level{i}": v for k, v in ret_i.items()})
        return ret

    def _render_stage(self, level, depth, std, near_far, feat_volume, feats,
                      batch, view_mask, ray_slice: RaySlice = None
                      ) -> Dict[str, torch.Tensor]:
        """Depth-guided rays, then IBR shading + compositing of one level:
        the variant hook (``ENeRFHuman`` renders its masked rays here)."""
        cas = self.cfg.cas_config
        grid = self.cfg.grid_rays and (cas.train_img[level]
                                       or not self.training)
        rays = self.build_level_rays(level, depth, std, near_far, batch, grid)
        return self.render_level(level, rays, feat_volume, feats, batch,
                                 view_mask, grid=grid, ray_slice=ray_slice)

    def build_level_rays(self, level, depth, std, near_far, batch, grid):
        """The batch's host-built rays of ``level`` with their depth-guided
        bounds (B, N, 12)."""
        cas = self.cfg.cas_config
        return build_rays(batch[f"rays_{level}"], depth, std, near_far,
                          depth_inv=cas.depth_inv[level],
                          up_scale=cas.render_scale[level] / cas.volume_scale[level],
                          grid=grid)

    def render_level(self, level, rays, feat_volume, feats, batch, view_mask,
                     grid: bool, window=None, ray_slice: RaySlice = None
                     ) -> Dict[str, torch.Tensor]:
        """Shade and composite ``rays`` (B, N, 12) of one level. ``grid``:
        the rays are the raster grid of the render frame or, with
        ``window`` (an ``ops.window.Window`` of the render frame), of that
        window. ``ray_slice=(rank, world)``: only the rank's contiguous
        N/world rays, the other rays' outputs 0; N not divisible by world
        raises ``ValueError``."""
        if ray_slice is not None:
            B, N = rays.shape[:2]
            r, world = ray_slice
            if N % world:
                raise ValueError(f"the {N} rays of level {level} do not split "
                                 f"over {world} ranks")
            part = local_batch_slice(N, r, world)
            out = self.render_level(level, rays[:, part], feat_volume, feats,
                                    batch, view_mask, grid=False)
            full = {}
            for k, v in out.items():
                full[k] = v.new_zeros((B, N) + v.shape[2:])
                full[k][:, part] = v
            return full
        cas = self.cfg.cas_config
        world_xyz, uvd, z_vals = sample_along_depth(
            rays, n_samples=cas.num_samples[level],
            depth_inv=cas.depth_inv[level])
        img_feat_rgb = image_features(cas, level, feats, batch["src_inps"])
        H, W = self.render_hw(level, batch)
        norm = torch.tensor([1.0 / (W - 1), 1.0 / (H - 1), 1.0],
                            dtype=uvd.dtype, device=uvd.device)
        render = (partial(render_rays_plain, table_bf16=self.table_bf16)
                  if self.training else render_rays)
        return render(
            world_xyz, uvd * norm, z_vals, img_feat_rgb, feat_volume,
            batch["src_exts"], batch["src_ixts"], batch["tar_ext"], view_mask,
            getattr(self, f"nerf_{level}"),
            render_scale=cas.render_scale[level],
            white_bkgd=self.cfg.white_bkgd,
            grid_hw=(H, W) if grid else None, window=window)

    @property
    def table_bf16(self) -> bool:
        """Whether the image table is rounded to bf16 before it is sampled:
        in training in the bf16 mode (``enerf_tpu/models/enerf.py:120-131``;
        the port's eval has no ``gather_bf16`` switch)."""
        return self.training and self.dtype == torch.bfloat16

    def render_hw(self, level, batch):
        """The (H, W) render frame of ``level``."""
        rs = self.cfg.cas_config.render_scale[level]
        H_O, W_O = batch["src_inps"].shape[2:4]
        return int(H_O * rs), int(W_O * rs)


def fpn_features(feature_net: FeatureNet, src_inps: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """``feature_net``'s three levels for all source views (B, S, H, W, 3),
    NHWC: ``level_0`` at 1/4, ``level_1`` at 1/2, ``level_2`` at full
    resolution."""
    B, S, H, W, C = src_inps.shape
    feat2, feat1, feat0 = feature_net(src_inps.reshape(B * S, H, W, C))
    return {
        "level_2": feat0.reshape(B, S, H, W, feat0.shape[-1]),
        "level_1": feat1.reshape(B, S, H // 2, W // 2, feat1.shape[-1]),
        "level_0": feat2.reshape(B, S, H // 4, W // 4, feat2.shape[-1]),
    }


def image_tables(cas, level: int, feats: Dict[str, torch.Tensor],
                 src_inps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The level's image features (B, S, H, W, C) and source rgb (B, S, H,
    W, 3) at render scale; ``cas`` the cascade config."""
    rgbs = unpreprocess(src_inps, render_scale=cas.render_scale[level])
    im_feat = feats[f"level_{cas.render_im_feat_level[level]}"]
    up_feat_scale = cas.render_scale[level] / cas.im_ibr_scale[level]
    if up_feat_scale != 1.0:
        h, w = im_feat.shape[2:4]
        im_feat = resize_bilinear(im_feat, (scale_size(h, up_feat_scale),
                                            scale_size(w, up_feat_scale)))
    return im_feat, rgbs


def image_features(cas, level: int, feats: Dict[str, torch.Tensor],
                   src_inps: torch.Tensor) -> torch.Tensor:
    """The level's image features ‖ source rgb at render scale,
    (B, S, H, W, C + 3) (``image_tables`` joined)."""
    return torch.cat(image_tables(cas, level, feats, src_inps), dim=-1)
