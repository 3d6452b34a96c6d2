"""IBR shading head; counterpart of ``enerf_tpu/models/nerf_head.py``
(``Agg``, ``NeRFHead``). This is the plain version of the head part of the
fused render kernel (``ops/kernels/render.py``).

Agg pools per-view features (view-direction gating, unbiased var + mean
across views, softmax attention); sigma from [vox_feat ‖ agg_feat]; color
is a softmax-weighted blend of the *source-view RGBs* (the rgb channels at
[..., -7:-4] of img_feat_rgb_dir). Padded views: ``view_mask`` (B, S)
drives masked mean/var and masked softmaxes (logit -1e9).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from enerf_tpu_torch.models.layers import LinearReLU

_NEG_INF = -1e9


def _masked_softmax(logits, mask, dim):
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    return torch.softmax(logits, dim=dim)


def _mean_var_views(x, mask):
    """Mean and unbiased variance over the view axis (-2), masked."""
    if mask is None:
        mean = torch.mean(x, dim=-2, keepdim=True)
        var = torch.sum((x - mean) ** 2, dim=-2, keepdim=True) / (x.shape[-2] - 1)
        return mean, var
    m = mask.to(x.dtype)
    cnt = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
    mean = torch.sum(x * m, dim=-2, keepdim=True) / cnt
    var = (torch.sum(((x - mean) ** 2) * m, dim=-2, keepdim=True)
           / torch.clamp(cnt - 1.0, min=1.0))
    return mean, var


class Agg(nn.Module):
    def __init__(self, feat_ch: int, viewdir_agg: bool = True):
        super().__init__()
        self.viewdir_agg = viewdir_agg
        if viewdir_agg:
            self.view_fc = LinearReLU(4, feat_ch)
        self.global_fc = LinearReLU(feat_ch * 3, 32)
        self.agg_w_fc = LinearReLU(32, 1)
        self.fc = LinearReLU(32, 16)

    def forward(self, img_feat_rgb_dir, view_mask=None):
        # img_feat_rgb_dir (B, P, S, feat_ch + 4); view_mask (B, 1, S, 1) bool
        img_feat_rgb = img_feat_rgb_dir[..., :-4]
        if self.viewdir_agg:
            img_feat_rgb = img_feat_rgb + self.view_fc(img_feat_rgb_dir[..., -4:])
        mean, var = _mean_var_views(img_feat_rgb, view_mask)
        feat = torch.cat([img_feat_rgb, var.expand_as(img_feat_rgb),
                          mean.expand_as(img_feat_rgb)], dim=-1)
        global_feat = self.global_fc(feat)
        agg_w = _masked_softmax(self.agg_w_fc(global_feat), view_mask, dim=-2)
        return self.fc(torch.sum(global_feat * agg_w, dim=-2))


class NeRFHead(nn.Module):
    """``use_vox_feat=False`` is the head of the composite model
    (``nerf_.py`` in the reference): sigma reads the 16-channel aggregate
    only, so ``lr0`` takes 16 inputs and ``color.0`` loses the vox ones, and
    ``vox_feat`` may be None."""

    def __init__(self, feat_ch: int, hid_n: int = 64, viewdir_agg: bool = True,
                 vox_ch: int = 8, use_vox_feat: bool = True):
        super().__init__()
        self.feat_ch = feat_ch
        self.viewdir_agg = viewdir_agg
        self.use_vox_feat = use_vox_feat
        in_ch = (vox_ch if use_vox_feat else 0) + 16
        self.agg = Agg(feat_ch, viewdir_agg)
        self.lr0 = LinearReLU(in_ch, hid_n)
        self.sigma = nn.Sequential(nn.Linear(hid_n, 1), nn.Softplus())
        self.color = nn.Sequential(
            nn.Linear(hid_n + in_ch + feat_ch + 4, hid_n), nn.ReLU(),
            nn.Linear(hid_n, 1), nn.ReLU())

    def forward(self, vox_feat: Optional[torch.Tensor],
                img_feat_rgb_dir: torch.Tensor,
                view_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """vox_feat (B, P, 8) (ignored without ``use_vox_feat``);
        img_feat_rgb_dir (B, P, S, feat_ch + 4); view_mask optional (B, S).
        Returns (B, P, 4) = rgb ‖ sigma."""
        B, P, S = img_feat_rgb_dir.shape[:3]
        vm = None if view_mask is None else (view_mask[:, None, :, None] != 0)
        img_feat = self.agg(img_feat_rgb_dir, vm)
        vox_img_feat = (torch.cat([vox_feat, img_feat], dim=-1)
                        if self.use_vox_feat else img_feat)
        x = self.lr0(vox_img_feat)
        sigma = self.sigma(x)
        x = torch.cat([x, vox_img_feat], dim=-1)
        x = torch.cat([x[:, :, None].expand(B, P, S, x.shape[-1]),
                       img_feat_rgb_dir], dim=-1)
        color_weight = _masked_softmax(self.color(x), vm, dim=-2)
        color = torch.sum(img_feat_rgb_dir[..., -7:-4] * color_weight, dim=-2)
        return torch.cat([color, sigma], dim=-1)
