"""The span readings on the CPU: the three readers of stages the program
marks (``stage_ms.depth_regression``, ``train_ms.forward``,
``train_ms.optimizer``) on a synthetic record; ``benchmark/spans.py``'s
gaps and launches by span on synthetic events, with gaps inside and
outside the program's ranges; its sync attribution by span and site on a
fake warning stream; and its recorded windows driving a small
interactive cell."""

import time
import warnings
from types import SimpleNamespace

import pytest

from benchmark import harness, spans, spec
from conftest import small
from enerf_tpu_torch.utils.profiling import span

SEED = 3141592653589


def _read(name, rec):
    return spec.load_reader(name).read(rec)


def test_stage_readers_on_a_synthetic_record():
    rec = {"units": 4, "work": {"cost_reg_stages": ["cost_reg_0", "cost_reg_1"]},
           "stage_kernel_s": {"depth_0": 1e-5, "depth_1": 3e-5,
                              "forward": 0.1, "optimizer": 0.002}}
    assert _read("stage_ms.depth_regression", rec) == pytest.approx(0.01)
    assert _read("train_ms.forward", rec) == pytest.approx(25.0)
    assert _read("train_ms.optimizer", rec) == pytest.approx(0.5)
    partial = dict(rec, stage_kernel_s={"depth_0": 1e-5})
    for name in ("stage_ms.depth_regression", "train_ms.forward",
                 "train_ms.optimizer"):
        assert _read(name, partial) is None
        assert _read(name, dict(rec, stage_kernel_s=None)) is None
        assert _read(name, dict(rec, units=0)) is None


def test_gaps_and_launches_by_span():
    """Ranges: render [0, 100] holding depth_0 [40, 60]; a gap inside
    depth_0, one in render alone, one outside both; launches by their
    runtime call's time, one record with no call."""
    ranges = spans.program_ranges([(0, 100, "enerf.render"),
                                   (40, 60, "enerf.depth_0"),
                                   (10, 20, "aten::mm")])
    assert ranges == [(0, 100, "render"), (40, 60, "depth_0")]
    gaps = [(45, 55), (10, 30), (120, 160), (70, 80)]
    got = dict(spans.idle_gaps_by_span(gaps, ranges))
    assert got == pytest.approx({"render": 30e-9, "depth_0": 10e-9,
                                 spans.OUTSIDE: 40e-9})
    dev = [(200, 5, "k", 1), (210, 5, "k", 2), (220, 5, "k", 3),
           (230, 5, "k", 4)]
    launched_at = {1: 50, 2: 5, 3: 150}
    assert spans.launches_by_span(dev, launched_at, ranges) == {
        "depth_0": 1, "render": 1, spans.OUTSIDE: 1, spans.UNATTRIBUTED: 1}


def test_syncs_by_span_and_site():
    """Each warning counted under the innermost open span and the line
    that raised it; other warnings ignored; the sync-debug mode set and
    reset."""
    modes = []
    fake = SimpleNamespace(cuda=SimpleNamespace(
        synchronize=lambda: None, set_sync_debug_mode=modes.append))

    def sync():
        warnings.warn("called a synchronizing CUDA operation")

    def frame():
        sync()
        with span("render"):
            with span("depth_0"):
                sync()
                sync()
                warnings.warn("something else")
            sync()

    rows = spans.count_syncs_by_site(fake, frame)
    assert modes == ["warn", "default"]
    assert spans.by(rows, 0) == {"depth_0": 2, spans.OUTSIDE: 1, "render": 1}
    sites = spans.by(rows, 1)
    assert sum(sites.values()) == 4 and len(sites) == 1
    [site] = sites
    assert site.startswith("benchmark/tests/test_bench_spans.py:")
    anc = {"depth_0": {"render"}, "render": set()}
    assert spans.under(spans.by(rows, 0), "render", anc) == 3


def test_recorded_windows_of_a_small_cell():
    """The interactive loop on the CPU at a small size: a unit a frame,
    the query's and the render's spans once each a unit, the stages
    under ``render``, the span metrics the cell reports."""
    r = small("zjumocap_interactive")
    run = harness.Run(r, SEED, "cpu", time.perf_counter())
    state = r["loop"].setup(run)
    plain, recorded, recs = spans.windows(run, r["loop"], state, 0.2)
    assert len(plain) == len(recorded) == len(recs) == spans.WINDOW_PAIRS
    units = sum(x["units"] for x in recorded)
    assert all(rec.unit == x["units"] for rec, x in zip(recs, recorded))
    a_unit = spans.per_unit(recs, units)
    for n in ("render", "query.upload", "query.finish", "depth_1"):
        assert a_unit[n]["count"] == pytest.approx(1.0)
    anc = spans.ancestors(recs)
    assert anc["depth_1"] == {"render"} and anc["render"] == set()
    per_unit = {n: {"host_ms": 1.0} for n in ("render", "query.upload",
                                              "query.finish")}
    rows = [["depth_1", "x.py:1", 8], ["query.upload", "y.py:2", 16]]
    got = spans.span_metrics(r, per_unit, rows, anc, 8, {})
    assert got == {"host_ms.forward": 1.0, "host_ms.upload": 1.0,
                   "host_ms.finish": 1.0, "syncs_per_frame.forward": 1.0}
