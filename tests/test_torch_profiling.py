"""The port's spans (``enerf_tpu_torch/utils/profiling.py``) on the CPU:
``span`` with recording off and on, the ranges a profiler session shows,
and the spans the program opens — the cascade's stages under ``render``
with ``stage_hook`` in its order, the train step's phases under
``train.step`` with ``phase_hook`` in its order, and the viewer dataset's
query. Sizes are the smoke config's (64x96, planes 16, 8)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import enerf_tpu_torch as et
from enerf_tpu_torch.config import make_cfg
from enerf_tpu_torch.datasets.synthetic import make_synthetic_batch
from enerf_tpu_torch.utils import profiling
from enerf_tpu_torch.utils.profiling import span
from tests.torch_threads import torch_threads_share  # noqa: F401 (autouse)

SMOKE = str(Path(__file__).resolve().parents[1] / "configs" / "enerf"
            / "synthetic_smoke.yaml")
H, W = 64, 96


def _no_range(*a, **k):
    raise AssertionError("opened a profiler range")


def test_span_off_and_on(monkeypatch):
    """Off: the hook once with the span's name, nothing stored, no
    profiler range. On: nesting, parents, units, ns times, the summary
    and ``current``."""
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _no_range)
    seen = []
    with span("a", seen.append):
        assert profiling.current() is None
    assert seen == ["a"]
    with pytest.raises(ValueError):
        with span("b", seen.append):
            raise ValueError
    assert seen == ["a"]          # no hook when the span raises

    with profiling.record() as rec:
        with span("outer"):
            with span("inner", seen.append):
                assert profiling.current() == "inner"
            assert profiling.current() == "outer"
        rec.next_unit()
        with span("inner"):
            pass
    with span("after"):
        pass
    assert profiling.current() is None and seen == ["a", "inner"]
    assert [(s.name, s.parent, s.unit) for s in rec.spans] == [
        ("outer", None, 0), ("inner", 0, 0), ("inner", None, 1)]
    outer, inner, again = rec.spans
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert outer.t1_ns <= again.t0_ns <= again.t1_ns
    summary = rec.summary()
    assert summary["inner"]["count"] == 2 and summary["outer"]["count"] == 1
    assert summary["inner"]["device_ms"] is None
    assert rec.host_ms("inner") == [inner.host_ms, again.host_ms]


def test_profiler_session_shows_spans():
    """A CPU ``torch.profiler`` session holds each span as an
    ``enerf.<name>`` op range around its ops, recording on or off, and
    as no user annotation (which the CUDA trace would mirror as a device
    record)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                x @ x
        with profiling.record():
            with span("recorded"):
                x + 1
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("enerf.")}
    assert set(ranges) == {"enerf.outer", "enerf.inner", "enerf.recorded"}
    assert not any(e.is_user_annotation() for e in ranges.values())
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"][0]
    inner = ranges["enerf.inner"]
    assert inner.start_ns() <= mm.start_ns() and mm.end_ns() <= inner.end_ns()


def _stages(cfg):
    cas = cfg.enerf.cas_config
    out = ["feature_net"]
    for i in range(cas.num):
        out += [f"cost_volume_{i}", f"cost_reg_{i}", f"depth_{i}"]
        if cas.render_if[i]:
            out.append(f"render_{i}")
    return out


def test_forward_records_its_stages_under_render():
    """A CPU ``render``: ``stage_hook`` sees the stages in their order,
    and exactly those stage spans are recorded, each under ``render``."""
    cfg = make_cfg(SMOKE)
    model = et.build_model(cfg, device="cpu")
    batch = make_synthetic_batch(cfg, H, W)
    hooks = []
    with profiling.record() as rec:
        et.render(model, batch, stage_hook=hooks.append)
    assert hooks == _stages(cfg)
    assert [s.name for s in rec.spans] == ["render"] + hooks
    assert [s.parent for s in rec.spans] == [None] + [0] * len(hooks)


def test_train_step_records_its_phases():
    """A CPU train step: ``phase_hook`` sees ``forward``, ``backward``,
    ``optimizer``; the phases' spans lie under ``train.step``, the model's
    stages under ``train.forward``."""
    from enerf_tpu_torch.train import create_train_state, make_train_step

    cfg = make_cfg(SMOKE)
    model = et.build_model(cfg, device="cpu", train=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, (H, W))
    batch = make_synthetic_batch(cfg, H, W, split="train")
    hooks = []
    with profiling.record() as rec:
        step(state, batch, phase_hook=hooks.append)
    assert hooks == ["forward", "backward", "optimizer"]
    top = [(s.name, s.parent) for s in rec.spans if s.parent in (None, 0)]
    fwd = [s.name for s in rec.spans].index("train.forward")
    assert top == [("train.step", None), ("train.forward", 0),
                   ("train.backward", 0), ("train.optimizer", 0)]
    assert [s.name for s in rec.spans if s.parent == fwd] == _stages(cfg)


def test_viewer_query_records_its_spans():
    """The viewer dataset's ``host_query``, ``upload`` and ``finish``
    record ``query.host``, ``query.upload`` and ``query.finish``."""
    from enerf_tpu_torch.datasets.zjumocap_interactive import Dataset

    cfg = make_cfg(SMOKE)
    ds = Dataset.__new__(Dataset)
    ds.cfg, ds.device = cfg, torch.device("cpu")
    ixt = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                   np.float32)
    X, Y = np.meshgrid(np.arange(W), np.arange(H))
    XYZ = np.stack([X, Y, np.ones_like(X)], -1).astype(np.float32)
    ds.input_h_w = [H, W]
    ds.XY = torch.from_numpy(np.stack([X, Y], -1).astype(np.float32))
    ds.XYZ = torch.from_numpy(XYZ @ np.linalg.inv(ixt).T)
    n = 4
    ds.exts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ds.exts[:, 2, 3] = 3.0 + np.arange(n)
    ds.ixts, ds.ixt = np.tile(ixt, (n, 1, 1)), ixt
    ds.cam_points = np.linalg.inv(ds.exts)[:, :3, 3]
    verts = np.array([[x, y, z] for x in (-.3, .3) for y in (-.3, .3)
                      for z in (-.3, .3)], np.float32)
    ds.cache = {0: {"inps": np.zeros((n, H, W, 3), np.float32),
                    "vertices": verts,
                    "bounds": np.stack([verts.min(0), verts.max(0)])}}
    with profiling.record() as rec:
        host = ds.host_query(0, np.linalg.inv(ds.exts[0]), ds.exts[0])
        batch = ds.finish(host, ds.upload(host))
    assert [s.name for s in rec.spans] == ["query.host", "query.upload",
                                           "query.finish"]
    assert ds.upload_bytes > 0 and batch["mask_at_box"].shape == (1, H * W)
