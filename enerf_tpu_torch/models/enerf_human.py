"""Human-capture variant; counterpart of ``enerf_tpu/models/enerf_human.py``
(reference ``lib/networks/enerf/network_human.py``): the cascade ENeRF with
its last level rendered, in eval, only inside the ray mask ``mask_at_box``
(the projected 3D bbox of the subject). Three modes, as in the JAX
package:

- ``mask_window_hw`` set, grid rays: render the raster sub-grid of a fixed
  (h, w) window on the mask, write it back into a zero frame and zero
  what lies outside the mask. The window's origin (first masked row and
  column, snapped down to 16 and clamped into the frame) is computed on the
  card and never read by the host. The render kernel samples the volume
  at each ray's uvd, so it takes the window's rays as they are.
- ``mask_ray_capacity == 1``: render every ray, multiply rgb by the mask.
- ``mask_ray_capacity < 1``: a stable argsort puts the masked rays first;
  the first K = capacity·N are rendered (as gathered rays, not a grid) and
  scattered back into zeros.

Training, and levels before the last, ignore the mask. The cascade
itself is ``ENeRF``'s; only the render hook ``_render_stage`` differs.
"""

from __future__ import annotations

from typing import Dict

import torch

from enerf_tpu_torch.models.enerf import ENeRF
from enerf_tpu_torch.ops.window import Window

# the window's origin snaps down to a multiple of this as in the JAX
# package (enerf_human.py:119-124, there for the TPU's sublanes): the same
# rule renders the same window
WINDOW_SNAP = 16


class ENeRFHuman(ENeRF):
    def _render_stage(self, level, depth, std, near_far, feat_volume, feats,
                      batch, view_mask, ray_slice=None
                      ) -> Dict[str, torch.Tensor]:
        """As ``ENeRF``'s; ``ray_slice`` splits the rays each mode renders
        (the window's, all of them, or the first K)."""
        cas = self.cfg.cas_config
        if not ("mask_at_box" in batch and not self.training
                and level == cas.num - 1):
            return super()._render_stage(level, depth, std, near_far,
                                         feat_volume, feats, batch, view_mask,
                                         ray_slice=ray_slice)
        grid = self.cfg.grid_rays
        rays = self.build_level_rays(level, depth, std, near_far, batch, grid)
        B, N = rays.shape[:2]
        mask = batch["mask_at_box"].reshape(B, N)
        args = (level, feat_volume, feats, batch, view_mask)
        if self.cfg.mask_window_hw is not None and grid:
            return self._render_window(rays, mask, *args, ray_slice=ray_slice)
        if self.cfg.mask_ray_capacity >= 1.0:
            out = self.render_level(level, rays, *args[1:], grid=grid,
                                    ray_slice=ray_slice)
            out["rgb"] = out["rgb"] * mask[..., None]
            return out
        return self._render_capacity(rays, mask, *args, ray_slice=ray_slice)

    def _render_capacity(self, rays, mask, level, feat_volume, feats, batch,
                         view_mask, ray_slice=None
                         ) -> Dict[str, torch.Tensor]:
        """The first ``mask_ray_capacity``·N rays of a stable argsort that
        puts the masked ones first, rendered and scattered into zeros."""
        B, N = rays.shape[:2]
        K = max(int(N * self.cfg.mask_ray_capacity), 1)
        idx = torch.argsort(1.0 - mask, dim=-1, stable=True)[:, :K]
        sub_rays = torch.take_along_dim(rays, idx[..., None], dim=1)
        valid = torch.take_along_dim(mask, idx, dim=1)
        # the rays are no longer in raster order: gathered vox sampling
        out = self.render_level(level, sub_rays, feat_volume, feats, batch,
                                view_mask, grid=False, ray_slice=ray_slice)
        scattered = {}
        for k, v in out.items():
            tail = (1,) * (v.ndim - 2)
            full = v.new_zeros((B, N) + v.shape[2:])
            scattered[k] = full.scatter(
                1, idx.reshape(idx.shape + tail).expand_as(v),
                v * valid.reshape(valid.shape + tail))
        return scattered

    def _render_window(self, rays, mask, level, feat_volume, feats, batch,
                       view_mask, ray_slice=None) -> Dict[str, torch.Tensor]:
        """The static (h, w) window on the mask, rendered as a raster
        sub-grid and written back into a zero frame."""
        B, N = rays.shape[:2]
        H, W = self.render_hw(level, batch)
        wh, ww = self.cfg.mask_window_hw
        if N != H * W or wh > H or ww > W:
            raise ValueError(
                f"the mask window {(wh, ww)} needs the full ({H}, {W}) grid "
                f"of rays inside which it fits, got {N} rays")
        mask2d = mask.reshape(B, H, W) > 0
        # the first masked row / column; an empty mask gives origin 0, and
        # the final mask multiply zeroes the frame
        y0 = torch.argmax(mask2d.any(dim=-1).to(mask.dtype), dim=-1)
        x0 = torch.argmax(mask2d.any(dim=-2).to(mask.dtype), dim=-1)
        y0 = torch.clamp(y0 // WINDOW_SNAP * WINDOW_SNAP, max=H - wh)
        x0 = torch.clamp(x0 // WINDOW_SNAP * WINDOW_SNAP, max=W - ww)
        # one window (and one index) cuts the rays and pastes every output
        win = Window(torch.stack([x0, y0], dim=-1), (wh, ww), (H, W))
        rays_win = win.crop(rays.reshape(B, H, W, -1))
        out = self.render_level(level, rays_win.reshape(B, wh * ww, -1),
                                feat_volume, feats, batch, view_mask,
                                grid=True, window=win, ray_slice=ray_slice)
        scattered = {}
        for k, v in out.items():
            tail = v.shape[2:]
            full = win.paste(v.reshape((B, wh, ww) + tail))
            m = mask.reshape((B, H, W) + (1,) * len(tail))
            scattered[k] = (full * m).reshape((B, N) + tail)
        return scattered
