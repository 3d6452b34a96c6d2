"""The program's spans in one cell, on the card: the readings that the
harness does not take yet (``PERF.md``, Open questions, names the edits
that would make them metrics). In one process, after set-up as
``benchmark/run.py`` makes it:

- rate windows of ``--seconds``, untraced and under
  ``profiling.record()`` in turn (no profiler, no sync-debug mode; the
  hook starts a unit at ``frame_start`` / ``step_start`` and launches
  nothing): each span's count and host ms a unit, and the cost of
  recording as the two kinds' rates;
- a traced slice as the benchmark's (``trace_units`` units, the profiler,
  spin-kernel marks), where each span is an ``enerf.<name>`` host range:
  the record that ``trace.reduce`` makes of it, the idle gaps summed by
  the innermost program span (``idle_gaps_by_span``) and the device
  records counted by the span whose runtime call launched them
  (``launches_by_span``);
- a sync count as the benchmark's, over ``sync_units`` (8 where the
  traffic sets none), each warning put down to ``profiling.current()``
  and to its ``file:line``.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--out FILE]

Prints one JSON line, the span metrics of ``PERF.md`` §3 under
``metrics``, and appends it to ``--out``; the tables by span go to
standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "4")

from benchmark import harness, spec  # noqa: E402
from benchmark import trace as tr  # noqa: E402
from enerf_tpu_torch.utils import profiling  # noqa: E402

OUTSIDE = "(outside the program)"
UNATTRIBUTED = "(no runtime call)"
STARTS = ("frame_start", "step_start")
WINDOW_PAIRS = 2


def innermost(ranges: List[Tuple[int, int, str]], times) -> List[str]:
    """For each time, the name of the shortest range (start_ns, end_ns,
    name) that holds it, ``OUTSIDE`` where none does."""
    if not ranges:
        return [OUTSIDE] * len(times)
    starts = np.array([r[0] for r in ranges], dtype=np.int64)
    ends = np.array([r[1] for r in ranges], dtype=np.int64)
    out = []
    for t in times:
        hit = np.nonzero((starts <= t) & (ends >= t))[0]
        out.append(ranges[hit[np.argmin(ends[hit] - starts[hit])]][2]
                   if hit.size else OUTSIDE)
    return out


def program_ranges(cpu) -> List[Tuple[int, int, str]]:
    """The program's spans among host records (start_ns, end_ns, name),
    without their prefix."""
    n = len(profiling.PREFIX)
    return [(s, e, name[n:]) for s, e, name in cpu
            if name.startswith(profiling.PREFIX)]


def idle_gaps_by_span(gaps, ranges) -> List[list]:
    """Idle gaps (start_ns, end_ns) summed in seconds by the innermost
    program span open at each gap's middle, most first."""
    names = innermost(ranges, [(g0 + g1) // 2 for g0, g1 in gaps])
    total: Dict[str, float] = {}
    for (g0, g1), name in zip(gaps, names):
        total[name] = total.get(name, 0.0) + (g1 - g0) * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])]


def launches_by_span(dev, launched_at: Dict[int, int], ranges
                     ) -> Dict[str, int]:
    """Device records (start_ns, duration_ns, name, correlation id) counted
    by the innermost program span open when the host call that launched
    each ran (``launched_at``: correlation id → its start_ns);
    ``UNATTRIBUTED`` where the trace holds no such call."""
    known = [d for d in dev if d[3] in launched_at]
    out = Counter(innermost(ranges, [launched_at[d[3]] for d in known]))
    if len(known) < len(dev):
        out[UNATTRIBUTED] = len(dev) - len(known)
    return dict(out.most_common())


def ancestors(recs) -> Dict[str, set]:
    """For each span name the recordings hold, the names of the spans it
    ran in."""
    out: Dict[str, set] = {}
    for rec in recs:
        for s in rec.spans:
            up, p = out.setdefault(s.name, set()), s.parent
            while p is not None:
                up.add(rec.spans[p].name)
                p = rec.spans[p].parent
    return out


def under(counts: Dict[str, int], name: str, anc: Dict[str, set]) -> int:
    """The counts of ``name`` and of every span that ran in it."""
    return sum(n for k, n in counts.items()
               if k == name or name in anc.get(k, ()))


def count_syncs_by_site(torch, run_once) -> List[list]:
    """``trace.count_syncs`` inside ``profiling.record()``, each warning
    kept as [innermost span, the ``file:line`` the warning names, count]
    (``profiling.current()`` is this thread's: syncs of autograd's own
    threads count ``OUTSIDE``)."""
    seen: Counter = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            try:
                filename = str(Path(filename).resolve().relative_to(ROOT))
            except ValueError:
                pass
            seen[(profiling.current() or OUTSIDE, f"{filename}:{lineno}")] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.record():
                run_once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [[s, site, n] for (s, site), n in seen.most_common()]


def by(rows: List[list], key: int) -> Dict[str, int]:
    out: Counter = Counter()
    for row in rows:
        out[row[key]] += row[2]
    return dict(out.most_common())


class UnitHook:
    """A window's stage hook: starts the recording's next unit at each
    frame or step start; launches nothing."""

    def __init__(self, rec):
        self.rec = rec

    def __call__(self, name: str) -> None:
        if name in STARTS:
            self.rec.next_unit()


def traced_slice(torch, run_units, tries: int = 4):
    """``trace.profile_slice``, keeping what the by-span tables need:
    (record, idle gaps by span, launches by span); None if every try
    lost its lead-in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        marks = tr.Marks(torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.lead_in(torch)
            t0 = time.perf_counter()
            units = run_units(marks)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        events = prof.profiler.kineto_results.events()
        dev = sorted(((e.start_ns(), e.duration_ns(), e.name(),
                       e.correlation_id()) for e in events
                      if e.device_type() == DeviceType.CUDA),
                     key=lambda t: t[0])
        spins = [i for i, d in enumerate(dev) if tr.SPIN in d[2]]
        n_lead = len(spins) - len(marks.names)
        if n_lead < 1:
            continue
        dev = dev[spins[n_lead - 1] + 1:]
        host = [e for e in events if e.device_type() == DeviceType.CPU]
        cpu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
               for e in host if e.duration_ns() > 0]
        rec = tr.reduce([d[:3] for d in dev], cpu, marks.names, units,
                        window_s)
        rec["lead_records_lost"] = tr.LEAD_LAUNCHES - n_lead
        ranges = program_ranges(cpu)
        ops = [d for d in dev if tr.SPIN not in d[2]]
        _, _, gaps = tr._busy([(s, s + d) for s, d, _, _ in ops])
        launched_at = {e.correlation_id(): e.start_ns() for e in host
                       if e.name().startswith("cu")}
        return (rec, idle_gaps_by_span(gaps, ranges),
                launches_by_span(ops, launched_at, ranges))
    return None


def span_metrics(resolved, spans_a_unit: Dict[str, dict], syncs_rows, anc,
                 sync_units: int, rec) -> Dict[str, float]:
    """The span rows of ``PERF.md`` §3 that this cell reports."""
    loop = resolved["traffic"]["loop"]
    out = {}
    if loop == "train":
        out["host_ms.step"] = spans_a_unit["train.step"]["host_ms"]
        names = ("train_ms.forward", "train_ms.optimizer")
    else:
        out["host_ms.forward"] = spans_a_unit["render"]["host_ms"]
        names = ("stage_ms.depth_regression",)
    if loop == "interactive":
        out["host_ms.upload"] = spans_a_unit["query.upload"]["host_ms"]
        out["host_ms.finish"] = spans_a_unit["query.finish"]["host_ms"]
        out["syncs_per_frame.forward"] = under(by(syncs_rows, 0), "render",
                                               anc) / sync_units
    for name in names:
        value = spec.load_reader(name).read(rec)
        if value is not None:
            out[name] = value
    return out


def windows(run, loop, state, seconds: float):
    """``WINDOW_PAIRS`` pairs of an untraced window and a recorded one,
    the first of each pair alternating: their results, and the recorded
    windows' recordings."""
    plain, recorded, recs = [], [], []
    for i in range(2 * WINDOW_PAIRS):
        state.kept = None
        if (i % 2) == (i // 2) % 2:
            plain.append(loop.window(run, state, seconds=seconds))
            continue
        with profiling.record() as rec:
            recorded.append(loop.window(run, state, seconds=seconds,
                                        hook=UnitHook(rec)))
        recs.append(rec)
    state.kept = None
    return plain, recorded, recs


def per_unit(recs, units: int) -> Dict[str, dict]:
    """Each span name's count and host ms over the recordings, a unit."""
    out: Dict[str, dict] = {}
    for rec in recs:
        for name, v in rec.summary().items():
            d = out.setdefault(name, {"count": 0.0, "host_ms": 0.0})
            d["count"] += v["count"] / units
            d["host_ms"] += v["host_ms"] / units
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=harness.RATE_SECONDS)
    ap.add_argument("--out", help="a JSON-lines file the line is appended to")
    args = ap.parse_args()
    harness.cache_env(ROOT)
    import torch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
    resolved = spec.resolve(spec.load_benchmark(), args.workload)
    loop, traffic = resolved["loop"], resolved["traffic"]
    run = harness.Run(resolved, args.seed, "cuda", T_START)
    tf32 = bool(resolved["config"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    state = loop.setup(run)
    run.sync()

    plain, recorded, recs = windows(run, loop, state, args.seconds)
    spans_a_unit = per_unit(recs, sum(r["units"] for r in recorded))
    anc = ancestors(recs)

    traced = traced_slice(torch, lambda marks: loop.window(
        run, state, units=traffic["trace_units"], hook=marks)["units"])
    if traced is None:
        raise RuntimeError("the profiler lost the lead-in of every session")
    rec, gaps_by_span, launches = traced
    rec["work"] = loop.work(run, state)
    state.kept = None
    n = traffic.get("sync_units", 8)
    syncs = count_syncs_by_site(torch, lambda: loop.window(run, state, units=n))

    listed = sum(s for _, s in rec["breakdown"]["idle_gaps"])
    no_host = sum(s for name, s in rec["breakdown"]["idle_gaps"]
                  if name == "(no host op)")
    line = {
        "workload": args.workload, "seed": args.seed,
        "device": harness.device_info(torch, 1),
        "rate": {"untraced": [r["units"] / r["seconds"] for r in plain],
                 "recorded": [r["units"] / r["seconds"] for r in recorded]},
        "spans_per_unit": spans_a_unit,
        "metrics": span_metrics(resolved, spans_a_unit, syncs, anc, n, rec),
        "traced": {"units": rec["units"], "launches": rec["launches"],
                   "idle_gaps": rec["breakdown"]["idle_gaps"],
                   "no_host_op_share": no_host / listed if listed else None,
                   "idle_gaps_by_span": gaps_by_span,
                   "launches_by_span": launches,
                   "stage_kernel_s": rec["stage_kernel_s"],
                   "lead_records_lost": rec["lead_records_lost"]},
        "syncs": {"units": n, "by_span": by(syncs, 0), "by_site": by(syncs, 1),
                  "rows": syncs}}
    print(f"spans {args.workload} seed {args.seed}: rate untraced "
          f"{line['rate']['untraced']} recorded {line['rate']['recorded']}",
          file=sys.stderr)
    for name, v in sorted(spans_a_unit.items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        print(f"  span {name:24s} host ms/unit {v['host_ms']:9.4f}  "
              f"count/unit {v['count']:.2f}", file=sys.stderr)
    for name, s in gaps_by_span:
        print(f"  idle {name:24s} ms/unit {1e3 * s / rec['units']:9.4f}",
              file=sys.stderr)
    for name, c in launches.items():
        print(f"  launches {name:24s} /unit {c / rec['units']:8.2f}",
              file=sys.stderr)
    for s, site, c in syncs:
        print(f"  syncs {s:24s} {site:50s} /unit {c / n:.3f}", file=sys.stderr)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    bad = harness.forbidden_modules()
    if bad:
        print(f"spans: loaded {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
