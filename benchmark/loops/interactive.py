"""The interactive free-viewpoint viewer (the paper's ``gui_human`` demo):
a closed loop, one frame at a time, over a pool of ``pool`` seeded video
frames made before the window. As the port's interactive dataset
(``enerf_tpu_torch/datasets/zjumocap_interactive.py``) caches them, a
frame waits on the host as numpy: its source images, cameras, near / far
and the performer's box, with the viewer's camera (c2w). Each frame runs
the viewer's per-query work through the port: the dataset's ``upload``
(the host arrays to the card) and ``finish`` (the rays of the camera and
``mask_at_box``, the slab test, on the card), then
``enerf_tpu_torch.render``, and its ``rgb_level{last}`` is copied back to
host numpy. ``frame_ms_p95`` is the 95th percentile of the window's
frames, each timed from the upload to its rgb on the host; ``fps`` the
frames over the window's seconds.

The check's reference renders the benchmark's own rays and mask of each
frame (``scene.py``, float64); rays whose slab margin (far − near) lies
within ``MASK_BAND`` metres of 0 are left out of the per-ray comparison,
since the port's float32 slab test may place them on either side."""

from __future__ import annotations

import time

import numpy as np

from benchmark import compare, scene
from benchmark.harness import Reservoir
from benchmark.loops import stream

# metres: ~2 % of a pixel's footprint at the performer (3 m / 573 px),
# some 30 times the float32 error of the port's near and far there
MASK_BAND = 1e-4

State = stream.State


def _queries(run, frame):
    """The port's interactive dataset over the benchmark's frames: its
    per-query conversion (``upload``, ``finish``) with the pixel grid's
    directions of the viewer's one intrinsic matrix on the device, as the
    dataset's constructor makes them."""
    import torch
    from enerf_tpu_torch.datasets.zjumocap_interactive import Dataset

    class Queries(Dataset):
        def __init__(self, cfg, device, ixt, hw):
            self.cfg, self.device = cfg, torch.device(device)
            self.input_h_w = list(hw)
            H, W = hw
            X, Y = np.meshgrid(np.arange(W), np.arange(H))
            XYZ = np.concatenate([X[..., None], Y[..., None],
                                  np.ones_like(X[..., None])], -1).astype(np.float32)
            self.XY = torch.from_numpy(np.concatenate(
                [X[..., None], Y[..., None]], -1).astype(np.float32)).to(self.device)
            self.XYZ = torch.from_numpy(XYZ @ np.linalg.inv(ixt).T).to(self.device)

    ixt = frame["tar_ixt"][0].cpu().numpy()
    return Queries(run.port_config(False), run.device, ixt, run.config["image_hw"])


def host_query(frame) -> dict:
    """A frame as the dataset's ``host_query`` hands it on: host numpy."""
    def host(k):
        return np.ascontiguousarray(frame[k][0].cpu().numpy())

    tar_ext = host("tar_ext")
    return {"c2w": np.linalg.inv(tar_ext.astype(np.float64)).astype(np.float32),
            "inps": host("src_inps"), "n_pad": 0, "bounds": host("bounds"),
            **{k: host(k) for k in ("tar_ext", "tar_ixt", "src_exts", "src_ixts",
                                    "view_mask", "near_far")}}


def setup(run) -> State:
    model = run.build_model(train=False)
    run.mark("model")
    t = run.traffic
    frames = scene.make_frames(run.config, t, run.seed, run.device, t["pool"])
    st = State(model, frames)
    st.extra["pool"] = [host_query(f) for f in frames]
    st.extra["queries"] = _queries(run, frames[0])
    run.mark("inputs")
    window(run, st, units=t["warmup"])
    stream.warm_allocator(run, st, window)
    run.mark("warmup")
    return st


def window(run, st: State, seconds=None, units=None, hook=None) -> dict:
    import enerf_tpu_torch as et

    t = run.traffic
    level = run.cascade(False)["num"] - 1
    rgb_key = f"rgb_level{level}"
    keys = [f"{k}_level{level}" for k in compare.RENDER_KEYS]
    kept = Reservoir(t["check_frames"], run.rng)
    pool, qs = st.extra["pool"], st.extra["queries"]
    lat = []
    k = 0
    t0 = time.perf_counter()
    while (k < units) if units is not None else (time.perf_counter() - t0 < seconds):
        host = pool[k % len(pool)]
        if hook:
            hook("frame_start")
        f0 = time.perf_counter()
        batch = qs.finish(host, qs.upload(host))
        out = et.render(st.model, batch, stage_hook=hook)
        rgb = out[rgb_key].cpu().numpy()
        lat.append(time.perf_counter() - f0)
        if hook:
            hook("frame_end")
        kept.offer(k % len(pool), lambda: dict(
            {key: out[key] for key in keys if key != rgb_key}, **{rgb_key: rgb}))
        k += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    st.kept, st.attempted = kept, k
    return {"fps": k / elapsed, "units": k, "seconds": elapsed,
            "frame_ms_p95": float(np.percentile(np.array(lat) * 1e3, 95))}


def work(run, st: State) -> dict:
    return stream.work_counts(run, st.frames)


def compared_rays(frame):
    """The reference's masked rays compared and the rays outside its mask
    that must be 0, each without the mask's band of doubt
    (``MASK_BAND``)."""
    level = max(int(k.split("_")[1]) for k in frame if k.startswith("rays_"))
    b = frame["bounds"][0].double()
    margin = scene.slab_margin(frame[f"rays_{level}"][0], b[0], b[1])
    sure = margin.abs() >= MASK_BAND
    return sure & (margin > 0), sure & (margin <= 0)


def check(run, st: State):
    return stream.check(run, st, rays=compared_rays)
