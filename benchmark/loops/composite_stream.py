"""ENeRF-Outdoor's composite model streamed as ``stream.py`` streams the
cascade: a ring of ``ring`` seeded ``outdoor_actor`` frames
(``scene_outdoor.py``) resident on the device, dispatched back to back
through ``enerf_tpu_torch.render``, at most ``in_flight`` enqueued ahead
of the card, the outputs left on the device, as the video export of
``actor1_path.yaml`` runs. ``fps`` is the frames completed over the
window's seconds.

The model is the port's ``ENeRFComposite`` through
``enerf_tpu_torch.build_model``, with the seeded weights of
``reference/enerf_composite.py``'s ``param_spec`` loaded strictly. The
check compares the sampled frames' last rendered level, ``rgb`` and
``depth``, with ``reference/enerf_composite.py`` over the frame and inside
the fg window at render scale (``*_win_*``); depth gaps are over the
frame's background far − near, the scene's depth range."""

from __future__ import annotations

import collections
import time

import torch

from benchmark import compare, gaps, scene_outdoor
from benchmark import work_composite as counts
from benchmark.harness import Reservoir
from benchmark.loops import stream
from benchmark.reference import enerf as ref
from benchmark.reference import enerf_composite as rc
from benchmark.weights import make_state
from benchmark.work import PEAKS

State = stream.State
KEYS = ("rgb", "depth")


def _last(run) -> int:
    cas = run.cascade(False)
    return max(i for i in range(cas["num"]) if cas["render_if"][i])


def weights(run) -> dict:
    """The seeded state dict of the configuration's composite, on the
    device."""
    e = run.config["enerf"]
    return make_state(rc.param_spec(run.cascade(False), e["num_fg_layers"],
                                    e["viewdir_agg"]), run.seed, run.device)


def setup(run) -> State:
    import enerf_tpu_torch as et

    model = et.build_model(run.port_config(False), device=run.device, train=False)
    model.load_state_dict(weights(run), strict=True)
    run.mark("model")
    t = run.traffic
    frames = scene_outdoor.make_frames(run.config, t, run.seed, run.device, t["ring"])
    run.mark("inputs")
    for f in frames[:t["warmup"]]:
        et.render(model, f)
    st = State(model, frames)
    stream.warm_allocator(run, st, window)
    run.mark("warmup")
    return st


def window(run, st: State, seconds=None, units=None, hook=None) -> dict:
    import enerf_tpu_torch as et

    t = run.traffic
    keys = [f"{k}_level{_last(run)}" for k in KEYS]
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


def work(run, st: State) -> dict:
    cas = run.cascade(False)
    H, W = run.config["image_hw"]
    S = run.config["source_views"]
    cfg = run.config
    return dict(counts.stages(cas),
                frame_flops=counts.frame_flops(cfg, cas, H, W, S),
                cost_volume_bytes=counts.cost_volume_bytes(cfg, cas, H, W, S),
                layer_render_flops=counts.layer_render_flops(cfg, cas, H, W, S),
                layer_render_bytes=counts.layer_render_bytes(cfg, cas, H, W, S),
                peaks=PEAKS)


def reference_config(run) -> dict:
    e = run.config["enerf"]
    return {"cas": run.cascade(False), "num_fg_layers": e["num_fg_layers"],
            "bg_volume_planes": e["bg_volume_planes"], "fg_bbox_hw": e["fg_bbox_hw"],
            "viewdir_agg": e["viewdir_agg"]}


def window_rays(frame: dict, cfg: dict, level: int) -> torch.Tensor:
    """(N,) bool: the rays of the last level inside the first fg layer's
    window at render scale."""
    rs = cfg["cas"]["render_scale"][level]
    fh, fw = cfg["fg_bbox_hw"]
    hr, wr = int(fh * rs), int(fw * rs)
    rays = frame[f"rays_{level}"][0]
    H, W = int(frame["src_inps"].shape[2] * rs), int(frame["src_inps"].shape[3] * rs)
    xy = rc.window_origin(frame["bbox"][:, 0, :2], rs, (hr, wr), (H, W))[0]
    px, py = rays[:, 6].long(), rays[:, 7].long()
    return (px >= xy[0]) & (px < xy[0] + wr) & (py >= xy[1]) & (py < xy[1] + hr)


def frame_numbers(got: dict, want: dict, frame: dict, cfg: dict, level: int) -> dict:
    """A frame's numbers: rgb (absolute) and depth (over the background's
    far − near), over the frame and inside the window (``*_win_*``)."""
    nf = frame["near_far"][0, -1]
    scale = {"rgb": 1.0, "depth": float(nf[1] - nf[0])}
    win = window_rays(frame, cfg, level)
    out = {}
    for k in KEYS:
        kind = "abs" if k == "rgb" else "rel"
        a, b = got[f"{k}_level{level}"], want[f"{k}_level{level}"]
        for where, pick in (("", None), ("win_", win)):
            for stat, v in gaps.gap_stats(a, b, scale[k], pick).items():
                out[f"{k}_{where}{stat}_{kind}"] = v
    return out


def check(run, st: State):
    frames = st.frames
    samples = st.kept.values()
    st.model = None
    if run.cuda:
        torch.cuda.empty_cache()
    cfg = reference_config(run)
    level = _last(run)
    params, stats = ref.split_state(weights(run))
    per_frame, want = [], {}
    for idx, got in samples:
        if idx not in want:
            with torch.no_grad(), compare.precision(False):
                want[idx] = rc.forward(params, stats, cfg, frames[idx])
        per_frame.append(frame_numbers(got, want[idx], frames[idx], cfg, level))
    numbers = compare.worst(per_frame)
    st.extra["numbers"] = numbers
    checks = compare.with_limits(numbers, run.traffic["limits"])
    st.failed = sum(1 for p in per_frame if any(p[n] > lim for n, _, lim in checks))
    return checks

