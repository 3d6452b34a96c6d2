"""Profiling helpers; counterpart of ``enerf_tpu/utils/profiling.py``
(reference perf_timer, lib/utils/net_utils.py:31-70: a stopwatch that
synchronizes the card before it reads the clock).

A helper synchronizes the CUDA devices of the tensors it is given
(``torch.cuda.synchronize``) and nothing on the CPU, where torch's calls
return when the work is done. ``trace`` is a ``torch.profiler`` session
that writes a Chrome trace.

Not ported: ``setup_compile_cache`` (JAX's persistent compile cache; the
port's kernels are cached by source hash under ``build/kernels``) and
``frame_latency_fori`` (N frames chained in one jitted ``fori_loop``,
because a remote TPU backend returns from ``block_until_ready`` early; a
CUDA event or ``torch.cuda.synchronize`` waits for the card).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Mapping, Optional

import torch


def _cuda_devices(value) -> Iterator[torch.device]:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value.device
    elif isinstance(value, Mapping):
        for v in value.values():
            yield from _cuda_devices(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _cuda_devices(v)


def synchronize(value) -> None:
    """Wait for every CUDA device that holds a tensor of ``value`` (a
    tensor, or a list, tuple or dict of them, nested); nothing else."""
    for dev in set(_cuda_devices(value)):
        torch.cuda.synchronize(dev)


class perf_timer:
    """Context manager + sequential ``logtime`` stopwatch. Before it reads
    the clock it synchronizes the card that holds ``sync_value`` (or the
    ``sync_value`` given to ``logtime``), so the numbers mean device time,
    like the reference's ``torch.cuda.synchronize()``."""

    def __init__(self, msg: str = "{:.3f}", use_ms: bool = True,
                 logf: Optional[Callable] = print, disabled: bool = False,
                 sync_value=None):
        self.msg = msg
        self.use_ms = use_ms
        self.logf = logf or print
        self.disabled = disabled
        self.sync_value = sync_value
        self._t = time.perf_counter()

    def __enter__(self):
        if not self.disabled:
            synchronize(self.sync_value)
            self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.disabled:
            self.logtime(self.msg)
        return False

    def logtime(self, msg: Optional[str] = None, sync_value=None):
        if self.disabled:
            return
        synchronize(self.sync_value if sync_value is None else sync_value)
        now = time.perf_counter()
        dt = (now - self._t) * (1000.0 if self.use_ms else 1.0)
        if msg:
            try:
                self.logf(msg.format(dt))
            except (IndexError, KeyError):
                self.logf(f"{msg} {dt:.3f}")
        self._t = time.perf_counter()


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """A ``torch.profiler`` session (the CPU, and CUDA where a card is
    present) that writes ``trace.json`` (Chrome trace format; open it in
    Perfetto or chrome://tracing) to ``log_dir``. Yields the profiler."""
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


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> float:
    """Mean seconds per call, synchronized on the card that holds the
    output, warmup excluded (the reference's FPS methodology,
    run.py:62-76)."""
    for _ in range(warmup):
        synchronize(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    synchronize(out)
    return (time.perf_counter() - t0) / iters
