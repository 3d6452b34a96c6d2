"""One run of one cell: set-up, the measured window, the traced slice, the
output check against the plain reference, and the result line.

``main`` is what ``benchmark/run.py`` calls. The cell's loop module
(``loops/<loop>.py``) supplies four functions:

- ``setup(run)``: builds the program's model (weights from the seed),
  makes the cell's inputs from the seed, warms every shape the cell uses;
  returns the loop's state.
- ``window(run, state, seconds=None, units=None, hook=None)``: drives the
  timed path for ``seconds`` (or ``units`` frames or steps, with ``hook``
  as the stage hook in the traced slice) and returns its end-to-end
  numbers ({metric: value}); it keeps what the check compares.
- ``work(run, state)``: the counts the readers need (FLOPs a unit, K1
  bytes, K2 FLOPs).
- ``check(run, state)``: frees the program's state, runs the reference
  and returns the compared numbers [(name, value, limit)].
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "enerf_tpu")
# the untraced window before a traced slice, whose rate the whole frame's
# and step's shares of the peak (``mfu.*``) read
RATE_SECONDS = 3.0


def cache_env(root: Path) -> None:
    """Every build and kernel cache a run may write, at fixed paths inside
    the checkout (the port's own kernel cache is ``build/kernels/``), and
    no library loading JAX on its own."""
    base = root / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(base / "nv"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``enerf_tpu_torch`` is not ``enerf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a loop needs of the run: its arguments, the cell's files, the
    device, the seeded weights, the port's configuration and model."""

    def __init__(self, resolved: dict, seed: int, device: str,
                 t_start: Optional[float] = None):
        import torch

        self.torch = torch
        self.cell = resolved["cell"]
        self.config = resolved["config"]
        self.traffic = resolved["traffic"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 7])
        self._weights: Dict[bool, dict] = {}
        self.setup_parts: Dict[str, float] = {}
        self._t_mark = time.perf_counter() if t_start is None else t_start

    def mark(self, part: str) -> None:
        """Close the set-up part ``part`` (its seconds go to
        ``setup_parts``)."""
        self.sync()
        now = time.perf_counter()
        self.setup_parts[part] = now - self._t_mark
        self._t_mark = now

    # -- the device --------------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def event(self):
        """A recorded CUDA event (None on the CPU, where every op is done
        when its call returns)."""
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    # -- the model ---------------------------------------------------------
    def cascade(self, train: bool) -> dict:
        return spec.cascade(self.config, train)

    def weights(self, train: bool) -> dict:
        """The seeded state dict of the cascade run in ``train`` or eval,
        on the device (``weights.make_state``)."""
        if train not in self._weights:
            from benchmark.reference.enerf import param_spec
            from benchmark.weights import make_state
            self._weights[train] = make_state(param_spec(self.cascade(train)),
                                              self.seed, self.device)
        return self._weights[train]

    def port_config(self, train: bool):
        """The port's ``Config`` for this configuration."""
        from dataclasses import fields

        from enerf_tpu_torch.config import (CascadeConfig, Config, ENeRFConfig,
                                            SchedulerConfig, TrainConfig)

        def tup(v):
            return tuple(v) if isinstance(v, list) else v

        cas = CascadeConfig(**{k: tup(v) for k, v in self.cascade(train).items()})
        names = {f.name for f in fields(ENeRFConfig)}
        enerf = ENeRFConfig(cas_config=cas, **{k: tup(v) for k, v in
                                               self.config["enerf"].items()
                                               if k in names})
        t = self.config["train"]
        sched = SchedulerConfig(**{k: tup(v) for k, v in t["scheduler"].items()})
        train_cfg = TrainConfig(lr=t["lr"], eps=t["eps"],
                                weight_decay=t["weight_decay"],
                                grad_clip_value=t["grad_clip_value"],
                                scheduler=sched)
        return Config(network_module=self.config["network_module"], enerf=enerf,
                      train=train_cfg, ep_iter=t["ep_iter"])

    def build_model(self, train: bool):
        """The port's model through its entry point, with the seeded
        weights loaded."""
        import enerf_tpu_torch as et

        model = et.build_model(self.port_config(train), device=self.device,
                               train=train)
        model.load_state_dict(self.weights(train), strict=True)
        return model


class Reservoir:
    """A uniform sample, drawn from the run's seed, of ``size`` of the
    units a window produces (algorithm R)."""

    def __init__(self, size: int, rng):
        self.size = size
        self.rng = rng
        self.items: Dict[int, object] = {}
        self.seen = 0

    def offer(self, key: int, make):
        """Keep ``make()`` under ``key`` if the draw takes this unit."""
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.items[n] = (key, make())
            return
        j = int(self.rng.integers(0, n + 1))
        if j < self.size:
            self.items[j] = (key, make())

    def values(self):
        return [self.items[k] for k in sorted(self.items)]


def device_info(torch, chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
            "tf32": {"cuda_matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def read_layer_metrics(run_resolved: dict, rec: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in run_resolved["metrics"]["per_layer"]:
        value = spec.load_reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_ok(checks: List[Tuple[str, float, float]]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def execute(resolved: dict, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, tf32=None) -> dict:
    """One run without the chip test: set-up, window or traced slice,
    check. Returns the result's fields: ``e2e`` (the window's numbers) or
    ``record`` (what the readers read), the checks, and the run and the
    loop's state. ``tf32`` (a bool, or a pair for cuBLAS and cuDNN)
    overrides the configuration's precision: the program's own TF32 path
    is the control of ``correct``."""
    import torch

    loop = resolved["loop"]
    run = Run(resolved, seed, device, t_start)
    # the precision the configuration states (cuDNN's own default is TF32)
    if tf32 is None:
        tf32 = bool(resolved["config"]["tf32"])
    matmul, cudnn = (tf32, tf32) if isinstance(tf32, bool) else tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    if run.cuda:
        torch.ones(1, device=run.device).sum().item()
    run.mark("start")
    state = loop.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    out = {"setup_s": setup_s, "setup_parts": run.setup_parts}
    if trace:
        from benchmark import trace as tr
        rate = loop.window(run, state, seconds=RATE_SECONDS)
        # free the outputs it kept, so that the traced slice reuses their
        # cached blocks instead of allocating (a cudaMalloc synchronizes)
        state.kept = None
        rec = tr.profile_slice(torch, lambda marks: loop.window(
            run, state, units=resolved["traffic"]["trace_units"],
            hook=marks)["units"])
        if rec is None:
            raise RuntimeError("the profiler lost the lead-in of every session")
        n = resolved["traffic"].get("sync_units", 0)
        if n:
            rec["syncs"] = tr.count_syncs(torch, lambda: loop.window(run, state,
                                                                     units=n))
            rec["sync_units"] = n
        out["record"] = dict(rec, work=loop.work(run, state),
                             rate={"units": rate["units"],
                                   "seconds": rate["seconds"]})
    else:
        out["e2e"] = loop.window(run, state, seconds=seconds)
    out["attempted"] = state.attempted
    out["device"] = device_info(torch, resolved["cell"]["chips"]) if run.cuda else None
    out["checks"] = loop.check(run, state)
    out["failed"] = state.failed
    out["run"], out["state"] = run, state
    return out


def result_line(resolved: dict, out: dict, trace: bool) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, breakdown (traced), and the compared numbers last."""
    checks = out["checks"]
    ok = checks_ok(checks)
    if trace:
        rec = out["record"]
        metrics = read_layer_metrics(resolved, rec)
    else:
        units = {m["name"]: m["unit"] for m in resolved["metrics"]["end_to_end"]}
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {k: {"value": float(e2e[k]), "unit": units[k]} for k in units}
    device = dict(out["device"] or {})
    line = {"correct": ok, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if trace:
        rec = out["record"]
        device["busy_s"] = rec.get("busy_s")
        device["window_s"] = rec.get("window_s")
        if rec.get("breakdown"):
            line["breakdown"] = rec["breakdown"]
    line["setup_parts"] = out["setup_parts"]
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                 "once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    resolved = spec.resolve(spec.load_benchmark(), args.workload)
    import torch

    chips = resolved["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))

    out = execute(resolved, args.seed, args.seconds, bool(args.trace), "cuda",
                  t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}: refusing to report",
              file=sys.stderr)
        return 4
    line = result_line(resolved, out, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
