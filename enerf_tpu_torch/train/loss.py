"""Training loss; counterpart of ``enerf_tpu/train/loss.py`` (reference
``lib/train/losses/enerf.py`` NetworkWrapper).

Per rendered cascade level: MSE on rgb × ``loss_weight``; plus, when VGG
weights are given, 0.01 × ``loss_weight`` × the VGG16 perceptual loss on
the full rendered image (``train_img``) or on the sampled patches
(``num_patchs > 0``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from enerf_tpu_torch.config import ENeRFConfig
from enerf_tpu_torch.train.vgg import VGG16Blocks, vgg_perceptual_loss

_LN10 = math.log(10.0)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / _LN10


def compute_loss(output: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 cfg: ENeRFConfig, src_hw: Tuple[int, int],
                 vgg_params: Optional[VGG16Blocks] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, scalar stats). ``src_hw`` is the source image
    (H, W), used to reshape full-image renders for the perceptual term;
    ``vgg_params`` the VGG16 blocks (``load_vgg16_params``) or None."""
    cas = cfg.cas_config
    H_O, W_O = src_hw
    loss = None
    stats: Dict[str, torch.Tensor] = {}
    for i in range(cas.num):
        if not cas.render_if[i]:
            continue
        pred = output[f"rgb_level{i}"]
        gt = batch[f"rgb_{i}"]
        color_loss = torch.mean((pred - gt) ** 2)
        stats[f"color_mse_{i}"] = color_loss
        stats[f"psnr_{i}"] = mse2psnr(color_loss)
        term = cas.loss_weight[i] * color_loss
        loss = term if loss is None else loss + term

        if vgg_params is None:
            continue
        B = pred.shape[0]
        if cas.train_img[i]:
            s = cas.render_scale[i]
            H, W = int(H_O * s), int(W_O * s)
            inp = pred.reshape(B, H, W, 3)
            tar = gt.reshape(B, H, W, 3)
        elif cas.num_patchs[i] > 0:
            ps, nr, npc = cas.patch_size[i], cas.num_rays[i], cas.num_patchs[i]
            # patch rays follow the random rays (reference losses/enerf.py:39-51)
            inp = pred[:, nr:nr + npc * ps * ps].reshape(B * npc, ps, ps, 3)
            tar = gt[:, nr:nr + npc * ps * ps].reshape(B * npc, ps, ps, 3)
        else:
            continue
        p = vgg_perceptual_loss(inp, tar, vgg_params)
        loss = loss + 0.01 * cas.loss_weight[i] * p
        stats[f"perceptual_loss_{i}"] = p

    if loss is None:
        raise ValueError("no cascade level renders (render_if is all False)")
    stats["loss"] = loss
    return loss, stats
