"""The validation that DTU training runs every epoch (and ``run --type
evaluate``): ``Trainer.val`` itself, with ``factory.make_evaluator``'s
evaluator (PSNR and SSIM on the host, LPIPS on the card, on seeded VGG-16
weights written to a temporary file), on the training cascade in eval
mode (both levels rendered). Its loader is a ring of ``ring`` seeded
batches held as host numpy, each of ``view_slots`` view slots with the
configuration's source views real and the rest padded as the DTU dataset
pads them; each batch is uploaded, rendered and read back by
``Trainer.val``. A window is calls of ``Trainer.val`` over the ring.
``fps`` is the frames validated over the window's seconds.

The stage hook reaches ``Trainer.val`` (its ``render`` and its
``val.readback`` and ``val.evaluate`` spans) in the traced slice only,
where the program takes one. The check compares both levels' ``rgb`` and
``depth`` that ``Trainer.val`` read back with ``reference/enerf.py``'s
forward of the same batch, depth over the frame's far − near.
``reference_control`` reads the same numbers with the reference computed
in TF32 in the program's place, the control the limits are set against
(``benchmark/control_reference.py``).

The cell is not in ``BENCHMARK.json``: its window's fps follows the
host's numpy SSIM, which spreads past half the fps bound from run to run
(``PERF.md``, Open questions). ``CELL`` holds the entries the cell takes
there, for the runs and tests that add it to a copy."""

from __future__ import annotations

import inspect
import tempfile
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from benchmark import compare, gaps, scene
from benchmark import work as counts
from benchmark.harness import Reservoir
from benchmark.reference import enerf as ref

KEYS = ("rgb", "depth")
# the cell as BENCHMARK.json would hold it, with the per-layer metric only
# it reads, and the end-to-end and per-layer metrics that list it
CELL = {"name": "dtu_val", "config": "enerf_dtu", "traffic": "dtu_val", "chips": 1,
        "why": "512x640 Trainer.val: 8 host batches of 3 views in 4 slots uploaded, "
               "planes 64,8, both levels (K2-L0), read back; PSNR and SSIM on the host, "
               "LPIPS on the card"}
EVALUATE_METRIC = {"name": "stage_ms.evaluate", "unit": "ms", "better": "lower",
                   "source": "device_trace", "layer": "evaluator", "moves": "fps",
                   "workloads": ["dtu_val"]}
LISTED_IN = ("fps", "stage_ms.feature_net", "stage_ms.cost_reg",
             "stage_ms.depth_regression", "cost_volume_roofline", "render_roofline",
             "mfu.render", "device_idle.render")


def with_cell(bench: dict) -> dict:
    """A copy of ``bench`` (``BENCHMARK.json``'s dict) with the cell added."""
    out = {**bench, "workloads": bench["workloads"] + [CELL]}
    for part in ("end_to_end", "per_layer"):
        out[part] = [dict(m, workloads=m["workloads"] + ["dtu_val"])
                     if m["name"] in LISTED_IN else m for m in bench[part]]
    out["per_layer"].append(EVALUATE_METRIC)
    return out


@dataclass
class State:
    trainer: object
    train_state: object
    evaluator: object
    batches: list
    kept: object = None
    attempted: int = 0
    failed: int = 0
    extra: dict = field(default_factory=dict)


def host_batch(frame: dict, slots: int, cas: dict) -> dict:
    """A device frame as a padded host batch: ``slots`` view slots (zero
    images, identity extrinsics, the target's intrinsics in the padded
    ones), ``msk_{i}`` of ones beside each ``rgb_{i}``."""
    def host(v):
        return np.ascontiguousarray(v.cpu().numpy())

    b = {k: host(v) for k, v in frame.items()}
    S = b["src_inps"].shape[1]
    pad = slots - S
    b["src_inps"] = np.concatenate([b["src_inps"], np.zeros_like(b["src_inps"][:, :pad])], 1)
    b["src_exts"] = np.concatenate(
        [b["src_exts"], np.broadcast_to(np.eye(4, dtype=np.float32), (1, pad, 4, 4))], 1)
    b["src_ixts"] = np.concatenate(
        [b["src_ixts"], np.broadcast_to(b["tar_ixt"][:, None], (1, pad, 3, 3))], 1)
    b["view_mask"] = np.concatenate([b["view_mask"], np.zeros((1, pad), np.float32)], 1)
    for i in range(cas["num"]):
        if f"rgb_{i}" in b:
            b[f"msk_{i}"] = np.ones(b[f"rgb_{i}"].shape[:2], np.float32)
    return b


class Keeping:
    """The evaluator, handing each batch's read-back outputs to the
    window's reservoir (``kept``) under the batch's ring index."""

    def __init__(self, evaluator, batches):
        self.evaluator = evaluator
        self.index = {id(b): k for k, b in enumerate(batches)}
        self.kept = None
        self.keys = []

    def evaluate(self, output, batch):
        self.evaluator.evaluate(output, batch)
        self.kept.offer(self.index[id(batch)],
                        lambda: {k: output[k] for k in self.keys})

    def summarize(self):
        return self.evaluator.summarize()


def setup(run) -> State:
    from enerf_tpu_torch.eval.lpips import write_seeded_weights
    from enerf_tpu_torch.factory import make_evaluator
    from enerf_tpu_torch.train import Trainer, create_train_state

    t = run.traffic
    tmp = tempfile.TemporaryDirectory()
    cfg = replace(run.port_config(True), workspace=tmp.name)
    model = run.build_model(train=True)
    lpips = f"{tmp.name}/lpips_vgg.npz"
    write_seeded_weights(lpips, run.seed % 2 ** 32)
    evaluator = make_evaluator(cfg, device=run.device, lpips_path=lpips)
    run.mark("model")
    cas = run.cascade(True)
    frames = scene.make_frames(run.config, t, run.seed, run.device, t["ring"], train=True)
    batches = [host_batch(f, t["view_slots"], cas) for f in frames]
    run.mark("inputs")
    st = State(Trainer(cfg, train_step=None), create_train_state(cfg, model),
               Keeping(evaluator, batches), batches)
    st.extra["tmp"] = tmp
    window(run, st, units=t["warmup"])
    run.mark("warmup")
    return st


def _takes_hook(trainer) -> bool:
    return "stage_hook" in inspect.signature(trainer.val).parameters


def window(run, st: State, seconds=None, units=None, hook=None) -> dict:
    cas = run.cascade(True)
    st.evaluator.keys = [f"{k}_level{i}" for i in range(cas["num"]) if cas["render_if"][i]
                         for k in KEYS]
    st.evaluator.kept = kept = Reservoir(run.traffic["check_frames"], run.rng)
    ring = len(st.batches)
    extra = {"stage_hook": hook} if hook and _takes_hook(st.trainer) else {}

    def loader(n):
        for b in st.batches[:n]:
            if hook:
                hook("frame_start")
            yield b
            if hook:
                hook("frame_end")

    k = 0
    t0 = time.perf_counter()
    while (k < units) if units is not None else (time.perf_counter() - t0 < seconds):
        n = ring if units is None else min(ring, units - k)
        st.trainer.val(0, st.train_state, loader(n), st.evaluator, **extra)
        k += n
    run.sync()
    elapsed = time.perf_counter() - t0
    st.kept, st.attempted = kept, k
    return {"fps": k / elapsed, "units": k, "seconds": elapsed}


def work(run, st: State) -> dict:
    cas = run.cascade(True)
    H, W = run.config["image_hw"]
    S = run.config["source_views"]
    levels = [i for i in range(cas["num"]) if cas["render_if"][i]]
    rays = {i: float(st.batches[0][f"rays_{i}"].shape[1]) for i in levels}
    last = levels[-1]
    return {"frame_flops": counts.frame_flops(cas, H, W, S, rays),
            "cost_volume_bytes": counts.cost_volume_bytes(cas, H, W, S),
            "render_flops": counts.render_flops(cas, last, S, rays[last]),
            "render_stage": f"render_{last}",
            "cost_volume_stages": [f"cost_volume_{i}" for i in range(cas["num"])],
            "cost_reg_stages": [f"cost_reg_{i}" for i in range(cas["num"])],
            "peaks": counts.PEAKS}


def frame_numbers(got: dict, want: dict, batch: dict, levels) -> dict:
    """A frame's numbers of each rendered level: rgb (absolute) and depth
    (over far − near)."""
    nf = batch["near_far"].reshape(-1, 2)[0]
    scale = {"rgb": 1.0, "depth": float(nf[1] - nf[0])}
    out = {}
    for i in levels:
        for k in KEYS:
            kind = "abs" if k == "rgb" else "rel"
            for stat, v in gaps.gap_stats(got[f"{k}_level{i}"], want[f"{k}_level{i}"],
                                          scale[k]).items():
                out[f"{k}_level{i}_{stat}_{kind}"] = v
    return out


def check(run, st: State):
    samples = st.kept.values()
    st.trainer = st.train_state = st.evaluator = None
    if run.cuda:
        torch.cuda.empty_cache()
    cas = run.cascade(True)
    levels = [i for i in range(cas["num"]) if cas["render_if"][i]]
    params, stats = ref.split_state(run.weights(True))
    per_frame, want = [], {}
    for idx, got in samples:
        batch = {k: torch.from_numpy(v).to(run.device) for k, v in st.batches[idx].items()}
        if idx not in want:
            with torch.no_grad(), compare.precision(False):
                want[idx] = ref.forward(params, stats, cas, batch)
        per_frame.append(frame_numbers(got, want[idx], batch, levels))
    numbers = compare.worst(per_frame)
    st.extra["numbers"] = numbers
    checks = compare.with_limits(numbers, run.traffic["limits"])
    st.failed = sum(1 for p in per_frame if any(p[n] > lim for n, _, lim in checks))
    st.extra.pop("tmp").cleanup()
    return checks


def reference_control(run) -> dict:
    """The check's numbers, worst over the ring, with the reference
    computed in TF32 (cuDNN's and cuBLAS') in the program's place against
    the reference in float32: where a limit must fail."""
    cas = run.cascade(True)
    levels = [i for i in range(cas["num"]) if cas["render_if"][i]]
    t = run.traffic
    frames = scene.make_frames(run.config, t, run.seed, run.device, t["ring"], train=True)
    params, stats = ref.split_state(run.weights(True))
    per_frame = []
    for f in frames:
        batch = {k: torch.from_numpy(v).to(run.device)
                 for k, v in host_batch(f, t["view_slots"], cas).items()}
        with torch.no_grad():
            with compare.precision(True):
                got = ref.forward(params, stats, cas, batch)
            with compare.precision(False):
                want = ref.forward(params, stats, cas, batch)
        per_frame.append(frame_numbers(got, want, batch, levels))
    return compare.worst(per_frame)
