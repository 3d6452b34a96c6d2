"""Video visualizer (reference lib/visualizers/enerf.py); counterpart of
``enerf_tpu/eval/visualizer.py``.

Collects the rendered frames, crops a 10 % border (the top rows and the
left and right columns: the reference's ``[crop_h:, crop_w:-crop_w]``),
and writes ``color.mp4`` and a min-max normalized ``depth.mp4`` at
``cfg.fps`` (``utils/video.py``: Motion JPEG, the port's encoder); with
``cfg.save_result``, each frame's ``imgs/{fid:06d}_rgb.jpg`` and
``_dpt.jpg`` too (the port's JPEG encoder at quality 75, as imageio's
default). Outputs and batches arrive as numpy arrays. ``summarize``
returns the frame count and the host ms its encoding took.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config
from enerf_tpu_torch.utils.image_io import imwrite
from enerf_tpu_torch.utils.video import write_mp4


class Visualizer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.imgs = []
        self.depths = []
        os.makedirs(os.path.join(cfg.result_dir, "imgs"), exist_ok=True)

    def visualize(self, output: Dict[str, np.ndarray], batch: Dict) -> None:
        cfg = self.cfg
        H, W = batch["src_inps"].shape[2:4]
        i = cfg.enerf.cas_config.num - 1
        rs = cfg.enerf.cas_config.render_scale[i]
        h, w = int(H * rs), int(W * rs)
        pred_rgb = np.asarray(output[f"rgb_level{i}"]).reshape(h, w, 3)
        depth = np.asarray(output[f"depth_level{i}"]).reshape(h, w)
        ch, cw = int(h * 0.1), int(w * 0.1)
        pred_rgb = pred_rgb[ch:, cw:-cw]
        depth = depth[ch:, cw:-cw]
        self.imgs.append(pred_rgb)
        self.depths.append(depth)
        if cfg.save_result:
            fid = batch.get("meta", {}).get("frame_id", [len(self.imgs)])[0]
            imwrite(os.path.join(cfg.result_dir, f"imgs/{fid:06d}_rgb.jpg"),
                    native.f32_unit_to_u8(pred_rgb))
            d = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
            imwrite(os.path.join(cfg.result_dir, f"imgs/{fid:06d}_dpt.jpg"),
                    native.f32_unit_to_u8(d))

    def summarize(self) -> Dict[str, float]:
        cfg = self.cfg
        t0 = time.perf_counter()
        imgs = [native.f32_unit_to_u8(im) for im in self.imgs]
        write_mp4(os.path.join(cfg.result_dir, "color.mp4"), imgs, cfg.fps)
        d_min = min(d.min() for d in self.depths)
        d_max = max(d.max() for d in self.depths)
        depths = [native.f32_unit_to_u8((d - d_min) / max(d_max - d_min, 1e-8))
                  for d in self.depths]
        depths = [np.repeat(d[..., None], 3, axis=-1) for d in depths]
        write_mp4(os.path.join(cfg.result_dir, "depth.mp4"), depths, cfg.fps)
        encode_ms = 1e3 * (time.perf_counter() - t0)
        print(f"Save visualization results into {cfg.result_dir}")
        n = len(self.imgs)
        self.imgs, self.depths = [], []
        return {"frames": n, "encode_ms": encode_ms}
