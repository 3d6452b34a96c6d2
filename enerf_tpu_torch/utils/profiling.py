"""The port's spans: one tracing API for the model's stages, the viewer's
query, the train step's phases and the render; counterpart of
``enerf_tpu/utils/profiling.py``.

``span(name, hook=None)`` marks a stretch of the program. It costs
nothing that touches the card:

- It calls ``hook(name)`` when it closes without an error. The models'
  ``stage_hook`` and the train step's ``phase_hook`` are such hooks, so a
  hook sees each stage right after the stage is enqueued.
- While a ``torch.profiler`` session runs, it opens the host range
  ``enerf.<name>``, so the session shows the program's spans over the
  kernels, on the profiler's clock. The range is the profiler's own kind
  for an op (``torch._C._profiler._RecordFunctionFast``): a
  ``torch.profiler.record_function`` range is a user annotation, which the
  CUDA trace mirrors as one device record a span around the kernels the
  span launched, and device-time readings would count it as a kernel.
- While ``record()`` is on (in this thread), it stores
  ``Span(name, parent, unit, t0_ns, t1_ns)`` in the recording, timed by
  ``time.perf_counter_ns``; with ``record(device=True)`` also a CUDA event
  at each end, read once the caller has synchronized.

Recording is off unless a caller turns it on, and then a span launches
nothing and synchronizes nothing. ``trace(log_dir)`` is the operator's
exporter: a profiler session whose Chrome trace holds the spans.

Not ported: ``perf_timer`` and ``time_fn``, synchronizing stopwatches
(spans replace them), ``setup_compile_cache`` (JAX's persistent compile
cache; the port's kernels are cached by source hash under
``build/kernels``) and ``frame_latency_fori`` (N frames chained in one
jitted ``fori_loop``, because a remote TPU backend returns from
``block_until_ready`` early; a CUDA event waits for the card).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

PREFIX = "enerf."           # the host ranges' names in a profiler session


class Span(NamedTuple):
    """One span: ``parent`` is the index in ``Recording.spans`` of the
    span it ran in (None at the top), ``unit`` the frame or step
    (``Recording.next_unit``); ``t1_ns`` is 0 while it is open."""

    name: str
    parent: Optional[int]
    unit: int
    t0_ns: int
    t1_ns: int

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class Recording:
    """The spans of one ``record()``, in the order they opened."""

    def __init__(self, device: bool = False):
        self.device = device
        self.spans: List[Span] = []
        self.events: Dict[int, tuple] = {}   # span index -> (start, end)
        self.unit = 0
        self._open: List[int] = []

    def next_unit(self) -> int:
        """Start the next frame or step: later spans carry its number."""
        self.unit += 1
        return self.unit

    def current(self) -> Optional[str]:
        return self.spans[self._open[-1]].name if self._open else None

    def _enter(self, name: str) -> int:
        i = len(self.spans)
        parent = self._open[-1] if self._open else None
        if self.device:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[i] = (ev, None)
        self.spans.append(Span(name, parent, self.unit,
                               time.perf_counter_ns(), 0))
        self._open.append(i)
        return i

    def _exit(self, i: int) -> None:
        t1 = time.perf_counter_ns()
        if self.device:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[i] = (self.events[i][0], ev)
        self.spans[i] = self.spans[i]._replace(t1_ns=t1)
        self._open.pop()

    def _device_ms(self, i: int) -> float:
        start, end = self.events[i]
        return start.elapsed_time(end)

    def _closed(self, name: str) -> List[int]:
        return [i for i, s in enumerate(self.spans)
                if s.name == name and s.t1_ns]

    def host_ms(self, name: str) -> List[float]:
        """Each closed ``name`` span's host ms, in order."""
        return [self.spans[i].host_ms for i in self._closed(name)]

    def device_ms(self, name: str) -> List[float]:
        """Each closed ``name`` span's ms on the card between its two
        events, in order (``record(device=True)``; the caller has
        synchronized since the spans closed)."""
        return [self._device_ms(i) for i in self._closed(name)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """For each name, its closed spans' ``count``, ``host_ms`` and
        ``device_ms`` (None without ``device``), summed."""
        out: Dict[str, Dict[str, float]] = {}
        for i, s in enumerate(self.spans):
            if not s.t1_ns:
                continue
            d = out.setdefault(s.name, {
                "count": 0, "host_ms": 0.0,
                "device_ms": 0.0 if self.device else None})
            d["count"] += 1
            d["host_ms"] += s.host_ms
            if self.device:
                d["device_ms"] += self._device_ms(i)
        return out


_state = threading.local()


def _recording() -> Optional[Recording]:
    return getattr(_state, "rec", None)


class span:
    """``with span(name, hook):`` see the module's docstring."""

    __slots__ = ("name", "hook", "_rec", "_i", "_range")

    def __init__(self, name: str,
                 hook: Optional[Callable[[str], None]] = None):
        self.name = name
        self.hook = hook

    def __enter__(self) -> "span":
        self._rec = _recording()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        if self._rec is not None:
            self._i = self._rec._enter(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._rec is not None:
            self._rec._exit(self._i)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None and self.hook is not None:
            self.hook(self.name)
        return False


@contextlib.contextmanager
def record(device: bool = False) -> Iterator[Recording]:
    """Record this thread's spans while the block runs; yields the
    ``Recording`` (in memory only). ``device``: also time each span on
    the card by CUDA events. A nested ``record`` takes the spans until it
    ends."""
    rec, prev = Recording(device), _recording()
    _state.rec = rec
    try:
        yield rec
    finally:
        _state.rec = prev


def current() -> Optional[str]:
    """The innermost open span's name while recording, else None."""
    rec = _recording()
    return None if rec is None else rec.current()


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """A ``torch.profiler`` session (the CPU, and CUDA where a card is
    present) that writes ``trace.json`` (Chrome trace format; open it in
    Perfetto or chrome://tracing) to ``log_dir``, the program's spans as
    ``enerf.<name>`` ranges over the ops and kernels. Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
