"""Interactive free-viewpoint rendering of a human (reference
gui_human.py); counterpart of the repo's ``gui_human.py``::

    python -m enerf_tpu_torch.gui_human \\
        --cfg_file configs/enerf/interactive/zjumocap.yaml \\
        [--headless N] [--device cpu] [key value ...]

A frame: the camera's pose → the interactive dataset's query (host work,
the upload, the rays and ``mask_at_box`` on the card) → the network
(``ENeRFHuman`` from ``build_model`` with the newest checkpoint under
``cfg.trained_model_dir``; without one it warns and keeps the seeded
initialization) → the interactive visualizer on the outputs' host copy
(reference gui_human.py:85-120). It runs on the card unless ``--device
cpu`` is given.

Without ``--headless`` a glfw window shows each frame as an OpenGL texture
(``run_gui``; it needs a display, and raises where ``glfw.init()`` fails).
Controls: left-drag orbits about the origin, right-drag rotates in place,
middle- or shift-drag pans, ctrl keeps the up axis, the scroll wheel
moves along the view, W/A/S/D/Q/E move, SPACE toggles autoplay of the
frames, P the camera rail, -/= scrub the rail, T cycles the render type,
H toggles the on-screen panel (``draw_hud``: fps, frame, autoplay, rail,
render type, the keys), ESC quits.

``--headless N`` renders N frames along the camera rail (the B-splines
through the dataset's cameras) and writes ``interactive.mp4`` to
``cfg.result_dir`` (``utils/video.py``). Beside the fps of the last 10
frames (their trimmed mean, as the reference's counter) it prints each
frame's split: the query's host ms, the upload's ms and bytes, the device
ms of the rays and the forward (CUDA events; the host clock on the CPU),
the readback and visualizer's ms, the u8 conversion's ms; then the
encoding's ms.
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
from enerf_tpu_torch.interactive.font import draw_text


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m enerf_tpu_torch.gui_human",
        description="Render a ZJU-MoCap subject from a free viewpoint with "
                    "the PyTorch/CUDA port: in a window, or headless along "
                    "the camera rail.")
    parser.add_argument("--cfg_file",
                        default="configs/enerf/interactive/zjumocap.yaml")
    parser.add_argument("--headless", type=int, default=0, metavar="N",
                        help="render N rail frames to interactive.mp4 "
                             "instead of opening a window")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


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


def hud_lines(rend: Renderer) -> List[str]:
    """The on-screen panel's four lines: fps, frame and autoplay; the
    camera rail's state; the render type; the key bindings."""
    cam = rend.cam
    return [
        f"fps {rend.fps:5.2f}   frame {rend.frame_curr}"
        f"   play {'on' if rend.opt.autoplay else 'off'}",
        (f"rail {'on' if cam.on_cam_path else 'off'}"
         + (f" u={cam.cam_path_u:.2f}" if cam.on_cam_path else ""))
        if cam.has_cam_path else "rail n/a",
        f"view {rend.opt.type_mapping[rend.opt.type]}",
        "keys: SPACE play  P rail  -/= scrub  T view  H hud  ESC quit",
    ]


def draw_hud(img_u8: np.ndarray, rend: Renderer) -> np.ndarray:
    """Draw ``hud_lines`` into a u8 (H, W, 3) frame (in place when it is
    contiguous; returned): each line's baseline at y = 16 + 14 i, a black
    shadow one pixel down and right, then the white text, in the 5x7
    bitmap font of ``interactive/font.py`` (the JAX package draws the same
    lines with OpenCV's Hershey font; the pixels differ)."""
    out = np.ascontiguousarray(img_u8)
    for i, text in enumerate(hud_lines(rend)):
        y = 16 + 14 * i
        draw_text(out, text, (7, y + 1), (0, 0, 0))
        draw_text(out, text, (6, y), (255, 255, 255))
    return out


def run_gui(rend: Renderer) -> None:
    """The windowed GUI (reference gui_human.py:85-120): a glfw window of
    the dataset's size whose OpenGL texture takes each frame, flipped for
    GL, through a read framebuffer blit; the mouse and keys move the
    camera and set the options (the module's docstring). Raises where
    ``glfw.init()`` fails, as without a display."""
    import glfw
    import OpenGL.GL as gl

    if not glfw.init():
        raise RuntimeError("glfw.init() failed (no display? use --headless)")
    glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
    glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
    glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_COMPAT_PROFILE)
    window = glfw.create_window(rend.width, rend.height, "enerf-tpu", None,
                                None)
    if not window:
        glfw.terminate()
        raise RuntimeError("could not create glfw window")
    glfw.make_context_current(window)

    tex = gl.glGenTextures(1)
    gl.glBindTexture(gl.GL_TEXTURE_2D, tex)
    gl.glTexImage2D(gl.GL_TEXTURE_2D, 0, gl.GL_RGB8, rend.width, rend.height,
                    0, gl.GL_RGB, gl.GL_UNSIGNED_BYTE, None)
    gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MAG_FILTER,
                       gl.GL_NEAREST)
    gl.glTexParameteri(gl.GL_TEXTURE_2D, gl.GL_TEXTURE_MIN_FILTER,
                       gl.GL_NEAREST)
    fbo = gl.glGenFramebuffers(1)
    gl.glBindFramebuffer(gl.GL_READ_FRAMEBUFFER, fbo)
    gl.glFramebufferTexture2D(gl.GL_READ_FRAMEBUFFER, gl.GL_COLOR_ATTACHMENT0,
                              gl.GL_TEXTURE_2D, tex, 0)
    gl.glBindFramebuffer(gl.GL_READ_FRAMEBUFFER, 0)

    cam = rend.cam

    def mouse_button(_w, button, action, mods):
        x, y = glfw.get_cursor_pos(window)
        if action == glfw.PRESS:
            pan = (button == glfw.MOUSE_BUTTON_MIDDLE
                   or mods & glfw.MOD_SHIFT)
            about_origin = button == glfw.MOUSE_BUTTON_LEFT and not pan
            cam.begin_drag(x, y, is_pan=pan, about_origin=about_origin,
                           fix_y=bool(mods & glfw.MOD_CONTROL))
        elif action == glfw.RELEASE:
            cam.end_drag()

    def cursor_pos(_w, x, y):
        cam.drag_update(x, y)

    def scroll(_w, _dx, dy):
        cam.move(cam.v_front * 0.1 * dy)

    move_keys = {glfw.KEY_W: lambda: cam.v_front * 0.1,
                 glfw.KEY_S: lambda: -cam.v_front * 0.1,
                 glfw.KEY_A: lambda: -cam.v_right * 0.1,
                 glfw.KEY_D: lambda: cam.v_right * 0.1,
                 glfw.KEY_Q: lambda: -cam.v_world_up * 0.1,
                 glfw.KEY_E: lambda: cam.v_world_up * 0.1}

    def key(_w, k, _sc, action, _mods):
        if action not in (glfw.PRESS, glfw.REPEAT):
            return
        if k == glfw.KEY_ESCAPE:
            glfw.set_window_should_close(window, True)
        elif k == glfw.KEY_SPACE:
            rend.opt.autoplay = not rend.opt.autoplay
        elif k == glfw.KEY_P and cam.has_cam_path:
            cam.on_cam_path = not cam.on_cam_path
        elif k in (glfw.KEY_MINUS, glfw.KEY_EQUAL) and cam.has_cam_path:
            cam.cam_path_u = (cam.cam_path_u
                              + (0.02 if k == glfw.KEY_EQUAL else -0.02)) % 1.0
            cam.update_from_cam_path()
        elif k == glfw.KEY_T:
            rend.opt.type = (rend.opt.type + 1) % len(rend.opt.type_mapping)
        elif k == glfw.KEY_H:
            rend.opt.show_hud = not rend.opt.show_hud
        elif k in move_keys:
            cam.move(move_keys[k]())

    glfw.set_mouse_button_callback(window, mouse_button)
    glfw.set_cursor_pos_callback(window, cursor_pos)
    glfw.set_scroll_callback(window, scroll)
    glfw.set_key_callback(window, key)

    while not glfw.window_should_close(window):
        glfw.poll_events()
        img = native.f32_unit_to_u8(rend.render_next())
        if rend.opt.show_hud:
            img = draw_hud(img, rend)
        img = img[::-1]  # GL's rows run bottom-up
        gl.glClear(gl.GL_COLOR_BUFFER_BIT | gl.GL_DEPTH_BUFFER_BIT)
        gl.glBindTexture(gl.GL_TEXTURE_2D, tex)
        gl.glTexSubImage2D(gl.GL_TEXTURE_2D, 0, 0, 0, img.shape[1],
                           img.shape[0], gl.GL_RGB, gl.GL_UNSIGNED_BYTE,
                           np.ascontiguousarray(img))
        gl.glBindFramebuffer(gl.GL_READ_FRAMEBUFFER, fbo)
        gl.glBlitFramebuffer(0, 0, img.shape[1], img.shape[0],
                             0, 0, rend.width, rend.height,
                             gl.GL_COLOR_BUFFER_BIT, gl.GL_LINEAR)
        gl.glBindFramebuffer(gl.GL_READ_FRAMEBUFFER, 0)
        glfw.swap_buffers(window)
        glfw.set_window_title(window, f"enerf-tpu  fps: {rend.fps:.2f}")
    glfw.terminate()


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


def main(argv: Optional[List[str]] = None) -> Optional[Dict]:
    """Parse ``argv`` (default: the command line), build the renderer and
    run the windowed GUI, or with ``--headless N`` the headless loop;
    returns ``run_headless``'s result with the renderer and the init
    seconds (None after the window closes)."""
    args = parse_args(argv)
    t0 = time.perf_counter()
    cfg = make_cfg(args.cfg_file, args.opts)
    rend = Renderer(cfg, args.device)
    init_s = time.perf_counter() - t0
    print(f"init {init_s:.2f} s (dataset {rend.dataset_s:.2f} s)")
    if args.headless <= 0:
        run_gui(rend)
        return None
    res = run_headless(rend, args.headless)
    res.update(renderer=rend, init_s=init_s, dataset_init_s=rend.dataset_s)
    return res


if __name__ == "__main__":
    main()
