"""The traced run's readings: a torch.profiler session over a short slice
of the cell's own frames or steps, reduced to device time by stage,
launches, busy and idle time and the breakdown, and a count of the calls
that synchronize the host with the card.

Stages. The program calls ``stage_hook(name)`` right after it enqueues
each stage (``feature_net``, ``cost_volume_{i}``, ``cost_reg_{i}``,
``depth_{i}``, ``render_{i}``; the train step's ``phase_hook``:
``forward``, ``backward``, ``optimizer``), and the loops mark a frame's
start and end. In the traced slice each mark also launches one spin
kernel (``torch.cuda._sleep``), so on the card's single stream every
kernel lies between the marks that enclose its stage: a stage's device
time is the sum of the kernels between its opening mark and its own
(copies and fills are launches, not kernels of a stage), whatever later
implements it.

Copied from ``chip_smoke.py``: the lead-in that opens every session
(``lead_in``: a 20 ms pause, then 128 spin kernels that absorb the first
records the trace tends to lose; a session that lost all of them is run
again), the idle arithmetic of ``profile_device`` (1 − busy / span) and
``count_syncs`` (``torch.cuda.set_sync_debug_mode("warn")``).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

LEAD_PAUSE_S = 0.02
LEAD_LAUNCHES = 128
SPIN = "spin_kernel"          # the kernel of torch.cuda._sleep
TOP = 10                      # entries of each breakdown list
GAPS_ATTRIBUTED = 4000        # longest idle gaps named by the host op


def lead_in(torch) -> None:
    time.sleep(LEAD_PAUSE_S)
    for _ in range(LEAD_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


class Marks:
    """The stage hook of a traced slice: records each mark's name and
    launches a spin kernel in stream order."""

    def __init__(self, torch):
        self.torch = torch
        self.names: List[str] = []

    def __call__(self, name: str) -> None:
        self.names.append(name)
        self.torch.cuda._sleep(1)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def profile_slice(torch, run_units: Callable[[Marks], int], tries: int = 4
                  ) -> Optional[dict]:
    """Profile ``run_units(marks)`` (which runs the slice's frames or steps
    with ``marks`` as their stage hook and returns how many it ran) and
    reduce the session; None if every try lost its lead-in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        marks = Marks(torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            units = run_units(marks)
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        events = prof.profiler.kineto_results.events()
        dev = sorted(((e.start_ns(), e.duration_ns(), e.name()) for e in events
                      if e.device_type() == DeviceType.CUDA),
                     key=lambda t: t[0])
        # the marks come after the lead-in's synchronize and are never the
        # session's first records: the spins before them are the lead-in's
        spins = [i for i, d in enumerate(dev) if SPIN in d[2]]
        n_lead = len(spins) - len(marks.names)
        if n_lead < 1:
            continue
        cut = spins[n_lead - 1] + 1
        cpu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
               for e in events if e.device_type() == DeviceType.CPU
               and e.duration_ns() > 0]
        rec = reduce(dev[cut:], cpu, marks.names, units, window_s)
        rec["lead_records_lost"] = LEAD_LAUNCHES - n_lead
        return rec
    return None


def reduce(dev, cpu, names: List[str], units: int, window_s: float) -> dict:
    """The slice's record from its device events ``dev`` (start_ns,
    duration_ns, name) past the lead-in, in start order, its host events
    ``cpu`` (start_ns, end_ns, name) and the marks' names."""
    stage_s: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    ops = []
    m = 0
    n_marks = sum(1 for _, _, n in dev if SPIN in n)
    stages_ok = n_marks == len(names)
    for start, dur, name in dev:
        if SPIN in name:
            m += 1
            continue
        ops.append((start, start + dur))
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-9
        if stages_ok and not _is_copy(name) and m < len(names):
            stage_s[names[m]] = stage_s.get(names[m], 0.0) + dur * 1e-9
    busy, span, gaps = _busy(ops)
    # the steady part: from the end of the second unit on
    steady_from = None
    ends = [i for i, n in enumerate(names) if n in ("frame_end", "step_end")]
    if stages_ok and len(ends) > 2:
        spin_starts = [s for s, _, n in dev if SPIN in n]
        steady_from = spin_starts[ends[1]]
    s_busy, s_span, _ = _busy([o for o in ops if steady_from is None
                               or o[0] >= steady_from])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"units": units, "window_s": window_s, "busy_s": busy,
            "span_s": span, "launches": len(ops),
            "stage_kernel_s": stage_s if stages_ok else None,
            "steady_idle_share": (1.0 - s_busy / s_span) if s_span > 0 else None,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                          "idle_gaps": _gap_hosts(gaps, cpu)}}


def _busy(ops):
    """(busy seconds as the union of the intervals, span seconds, idle
    gaps [(start_ns, end_ns)])."""
    if not ops:
        return 0.0, 0.0, []
    ops = sorted(ops)
    busy, gaps = 0, []
    cur_s, cur_e = ops[0]
    for s, e in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy * 1e-9, (cur_e - ops[0][0]) * 1e-9, gaps


def _gap_hosts(gaps, cpu) -> List[list]:
    """The idle gaps' seconds summed by the innermost host op running at
    each gap's middle ("(no host op)" where none ran), the longest
    ``GAPS_ATTRIBUTED`` gaps, the ``TOP`` names with the most."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_ATTRIBUTED]
    starts = np.array([c[0] for c in cpu], dtype=np.int64)
    ends = np.array([c[1] for c in cpu], dtype=np.int64)
    total: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if hit.size:
            k = hit[np.argmin(ends[hit] - starts[hit])]
            name = cpu[k][2]
        else:
            name = "(no host op)"
        total[name] = total.get(name, 0.0) + (g1 - g0) * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def count_syncs(torch, run_once: Callable[[], object]) -> int:
    """The calls that synchronize the host with the card in one
    ``run_once()`` (``torch.cuda.set_sync_debug_mode("warn")``)."""
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            seen.append(1)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_once()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return len(seen)
