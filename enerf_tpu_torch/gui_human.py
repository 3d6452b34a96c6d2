"""Interactive free-viewpoint rendering of a human (reference
gui_human.py); counterpart of the repo's ``gui_human.py``, headless::

    python -m enerf_tpu_torch.gui_human \\
        --cfg_file configs/enerf/interactive/zjumocap.yaml --headless N \\
        [--device cpu] [key value ...]

A frame: the camera's pose → the interactive dataset's query (host work,
the upload, the rays and ``mask_at_box`` on the card) → the network
(``ENeRFHuman`` from ``build_model`` with the newest checkpoint under
``cfg.trained_model_dir``; without one it warns and keeps the seeded
initialization) → the interactive visualizer on the outputs' host copy
(reference gui_human.py:85-120). ``--headless N`` renders N frames along
the camera rail (the B-splines through the dataset's cameras) and writes
``interactive.mp4`` to ``cfg.result_dir`` (``utils/video.py``). It runs on
the card unless ``--device cpu`` is given.

Beside the fps of the last 10 frames (their trimmed mean, as the
reference's counter) it prints each frame's split: the query's host ms,
the upload's ms and bytes, the device ms of the rays and the forward (CUDA
events; the host clock on the CPU), the readback and visualizer's ms, the
u8 conversion's ms; then the encoding's ms.

Not ported: the windowed GUI (glfw + OpenGL blit, the mouse and key
bindings) and its on-screen panel, which needs a glyph renderer of the
port's own; without ``--headless`` the CLI exits with a usage error.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from enerf_tpu_torch import native, resolve_device
from enerf_tpu_torch.config import Config, make_cfg


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m enerf_tpu_torch.gui_human",
        description="Render a ZJU-MoCap subject along the camera rail with "
                    "the PyTorch/CUDA port, headless.")
    parser.add_argument("--cfg_file",
                        default="configs/enerf/interactive/zjumocap.yaml")
    parser.add_argument("--headless", type=int, default=0, metavar="N",
                        help="render N rail frames to interactive.mp4")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.headless <= 0:
        parser.error("the windowed GUI (glfw + OpenGL and its on-screen "
                     "panel) is not ported to enerf_tpu_torch: pass "
                     "--headless N to render N rail frames to "
                     "interactive.mp4")
    return args


class Renderer:
    """The network, the interactive dataset and the camera (reference
    gui_human.py:30-120)."""

    def __init__(self, cfg: Config, device=None):
        from enerf_tpu_torch.datasets.loader import make_dataset
        from enerf_tpu_torch.factory import make_visualizer
        from enerf_tpu_torch.interactive.camera import Camera
        from enerf_tpu_torch.interactive.render_options import make_options
        from enerf_tpu_torch.run import DeviceClock, load_eval_model

        self.cfg = cfg
        self.device = resolve_device(device)
        self.clock = DeviceClock(self.device)
        self.opt = make_options(cfg)
        self.visualizer = make_visualizer(cfg)
        print("Loading dataset...")
        t0 = time.perf_counter()
        self.dataset = make_dataset(cfg, "test", device=self.device)
        self.dataset_s = time.perf_counter() - t0

        self.frame_start = cfg.test_dataset.frames[0]
        self.frame_step = cfg.test_dataset.frames[2]
        self.frame_cnt = len(self.dataset)
        self.iter = 0

        worldup, front, center = self.dataset.get_camera_up_front_center()
        cen_tck, _, fro_tck, _, wup_tck, _ = self.dataset.get_camera_tck(
            smoothing_term=self.opt.smoothing_term)
        self.cam = Camera(worldup=worldup, front=front, center=center,
                          center_tck=cen_tck, front_tck=fro_tck,
                          worldup_tck=wup_tck)

        print("Loading network...")
        self.model = load_eval_model(cfg, self.device)
        self.height, self.width = self.dataset.input_h_w
        self.fps_hist: List[float] = []
        self.splits: List[Dict[str, float]] = []
        self.last_host = self.last_batch = self.last_out = None

    @property
    def frame_curr(self) -> int:
        return self.frame_start + self.iter * self.frame_step

    def render_next(self) -> np.ndarray:
        """The next frame at the camera's pose (float (H, W, 3) in [0, 1]);
        its time split is appended to ``splits``."""
        t0 = time.perf_counter()
        host = self.dataset.host_query(self.frame_curr, self.cam.get_c2w(),
                                       self.cam.get_w2c())
        t1 = time.perf_counter()
        e0 = self.clock.mark()
        batch = self.dataset.upload(host)
        e1 = self.clock.mark()
        batch = self.dataset.finish(host, batch)
        e2 = self.clock.mark()
        if self.opt.autoplay:
            self.iter = (self.iter + 1) % self.frame_cnt
        with torch.inference_mode():
            out = self.model(batch)
        e3 = self.clock.mark()
        self.clock.sync()
        t2 = time.perf_counter()
        ret = self.visualizer.visualize(
            {k: v.cpu().numpy() for k, v in out.items()}, batch)
        img = ret[self.opt.type_mapping[self.opt.type]]
        t3 = time.perf_counter()
        self.fps_hist.append(1.0 / max(t3 - t0, 1e-6))
        self.fps_hist = self.fps_hist[-10:]
        self.splits.append({
            "query_host_ms": 1e3 * (t1 - t0),
            "upload_ms": self.clock.ms(e0, e1),
            "upload_bytes": self.dataset.upload_bytes,
            "rays_mask_ms": self.clock.ms(e1, e2),
            "forward_ms": self.clock.ms(e2, e3),
            "readback_visualize_ms": 1e3 * (t3 - t2),
            "frame_host_ms": 1e3 * (t3 - t0)})
        self.last_host, self.last_batch, self.last_out = host, batch, out
        return np.asarray(img)

    @property
    def fps(self) -> float:
        """Trimmed mean of the last 10 samples (reference :202-224)."""
        h = sorted(self.fps_hist)
        h = h[1:-1] if len(h) > 2 else h
        return float(np.mean(h)) if h else 0.0


def run_headless(rend: Renderer, n_frames: int) -> Dict:
    """Render ``n_frames`` frames along the camera rail (u = i / n) and
    write ``interactive.mp4``; returns the frames' splits, the fps, the
    encoding's ms, the file's path and the first frame's host query,
    batch and outputs."""
    from enerf_tpu_torch.utils.video import write_mp4

    rend.cam.on_cam_path = True
    frames, first = [], None
    for i in range(n_frames):
        rend.cam.cam_path_u = i / max(n_frames, 1)
        rend.cam.update_from_cam_path()
        img = rend.render_next()
        t0 = time.perf_counter()
        frames.append(native.f32_unit_to_u8(img))
        rend.splits[-1]["u8_ms"] = 1e3 * (time.perf_counter() - t0)
        if first is None:
            first = (rend.last_host, rend.last_batch, rend.last_out)
        s = rend.splits[-1]
        print(f"frame {i + 1}/{n_frames}  fps={rend.fps:.2f}  query "
              f"{s['query_host_ms']:.2f} ms  upload {s['upload_ms']:.3f} ms "
              f"({s['upload_bytes']} B)  rays+mask {s['rays_mask_ms']:.3f} "
              f"ms  forward {s['forward_ms']:.2f} ms  readback+visualize "
              f"{s['readback_visualize_ms']:.2f} ms  u8 {s['u8_ms']:.2f} ms")

    os.makedirs(rend.cfg.result_dir, exist_ok=True)
    path = os.path.join(rend.cfg.result_dir, "interactive.mp4")
    t0 = time.perf_counter()
    write_mp4(path, frames, rend.cfg.fps)
    encode_ms = 1e3 * (time.perf_counter() - t0)
    steady = rend.splits[1:] or rend.splits
    medians = {k: statistics.median(s[k] for s in steady)
               for k in steady[0]}
    print(f"wrote {path}  encode {encode_ms:.2f} ms for {n_frames} frames")
    print(f"steady fps {rend.fps:.2f}; medians over frames 2..{n_frames}: "
          + "  ".join(f"{k} {v:.3f}" for k, v in medians.items()))
    return {"frames": n_frames, "fps": rend.fps, "splits": rend.splits,
            "median_splits": medians, "encode_ms": encode_ms, "path": path,
            "frame_hw": list(frames[0].shape[:2]), "first_host": first[0],
            "first_batch": first[1], "first_out": first[2]}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``argv`` (default: the command line), build the renderer and
    run the headless loop; returns ``run_headless``'s result with the
    renderer and the init seconds."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    cfg = make_cfg(args.cfg_file, args.opts)
    rend = Renderer(cfg, args.device)
    init_s = time.perf_counter() - t0
    print(f"init {init_s:.2f} s (dataset {rend.dataset_s:.2f} s)")
    res = run_headless(rend, args.headless)
    res.update(renderer=rend, init_s=init_s, dataset_init_s=rend.dataset_s)
    return res


if __name__ == "__main__":
    main()
