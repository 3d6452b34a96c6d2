"""Frames streamed back to back through ``enerf_tpu_torch.render``: a ring
of ``ring`` seeded frames resident on the device, at most ``in_flight``
frames enqueued ahead of the card (a CUDA event a frame), the outputs left
on the device, as an eval pass or a video export runs. ``fps`` is the
frames completed over the window's seconds."""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import torch

from benchmark import compare, scene
from benchmark.harness import Reservoir
from benchmark import work as counts


@dataclass
class State:
    model: object
    frames: list
    kept: object = None
    attempted: int = 0
    failed: int = 0
    extra: dict = field(default_factory=dict)


def _human(run) -> bool:
    return run.config["network_module"].endswith("enerf_human")


def setup(run) -> State:
    import enerf_tpu_torch as et

    model = run.build_model(train=False)
    run.mark("model")
    t = run.traffic
    frames = scene.make_frames(run.config, t, run.seed, run.device, t["ring"])
    run.mark("inputs")
    for f in frames[:t["warmup"]]:
        et.render(model, f)
    st = State(model, frames)
    warm_allocator(run, st, window)
    run.mark("warmup")
    return st


def warm_allocator(run, st, window_fn) -> None:
    """A throwaway window of as many frames as the check keeps, and a few
    more, so that the caching allocator holds every block the window's
    kept outputs need before the window (a cudaMalloc synchronizes)."""
    t = run.traffic
    window_fn(run, st, units=t["check_frames"] + t.get("in_flight", 1) + 2)
    st.kept = None


def window(run, st: State, seconds=None, units=None, hook=None) -> dict:
    import enerf_tpu_torch as et

    t = run.traffic
    level = run.cascade(False)["num"] - 1
    keys = [f"{k}_level{level}" for k in compare.RENDER_KEYS]
    kept = Reservoir(t["check_frames"], run.rng)
    pending = collections.deque()
    ring = len(st.frames)
    k = 0
    t0 = time.perf_counter()
    while (k < units) if units is not None else (time.perf_counter() - t0 < seconds):
        if hook:
            hook("frame_start")
        out = et.render(st.model, st.frames[k % ring], stage_hook=hook)
        if hook:
            hook("frame_end")
        kept.offer(k % ring, lambda: {key: out[key] for key in keys})
        pending.append(run.event())
        if len(pending) >= t["in_flight"]:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
        k += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    st.kept, st.attempted = kept, k
    return {"fps": k / elapsed, "units": k, "seconds": elapsed}


def work_counts(run, frames) -> dict:
    """The per-frame counts of the readers: rays rendered at the last level
    (the mask's rays for the performer), model FLOPs, K1 bytes, K2 FLOPs."""
    cas = run.cascade(False)
    H, W = run.config["image_hw"]
    S = run.config["source_views"]
    level = cas["num"] - 1
    if _human(run):
        rays = sum(float(f["mask_at_box"].sum()) for f in frames) / len(frames)
    else:
        rays = float(frames[0][f"rays_{level}"].shape[1])
    return {"frame_flops": counts.frame_flops(cas, H, W, S, {level: rays}),
            "cost_volume_bytes": counts.cost_volume_bytes(cas, H, W, S),
            "render_flops": counts.render_flops(cas, level, S, rays),
            "render_stage": f"render_{level}",
            "cost_volume_stages": [f"cost_volume_{i}" for i in range(cas["num"])],
            "cost_reg_stages": [f"cost_reg_{i}" for i in range(cas["num"])],
            "peaks": counts.PEAKS}


def work(run, st: State) -> dict:
    return work_counts(run, st.frames)


def masked_rays(frame):
    """The performer's rays compared (the reference's mask) and those
    whose outputs must be 0 (the rest)."""
    m = frame["mask_at_box"][0] > 0
    return m, ~m


def check(run, st: State, rays=None):
    """The sampled frames against the reference; ``rays(frame)`` gives the
    rays whose outputs are compared and those that must be 0 (for the
    performer ``masked_rays`` by default)."""
    if rays is None and _human(run):
        rays = masked_rays
    frames = st.frames
    samples = st.kept.values()
    st.model = None
    if run.cuda:
        torch.cuda.empty_cache()
    cas = run.cascade(False)
    level = cas["num"] - 1
    state = run.weights(False)
    per_frame = []
    for idx, got in samples:
        want = compare.reference_frame(state, cas, frames[idx], _human(run), level)
        got = {k: got[f"{k}_level{level}"] for k in compare.RENDER_KEYS}
        picked = (None, None) if rays is None else rays(frames[idx])
        per_frame.append(compare.render_gaps(got, want, frames[idx], *picked))
    numbers = compare.worst(per_frame)
    st.extra["numbers"] = numbers
    checks = compare.with_limits(numbers, run.traffic["limits"])
    st.failed = sum(1 for p in per_frame
                    if any(p[n] > lim for n, _, lim in checks))
    return checks
