"""The ``enerf_outdoor`` configuration and the ``outdoor_composite`` and
``dtu_val`` cells on the CPU: the reference's ``param_spec`` against the
port's state dict at the published widths, the ``outdoor_actor`` scene's
fg window, the composite's counts against ``FlopCounterMode`` run on the
reference and by hand at the cell's shapes, the readers of the
composite's stages and of ``val.evaluate`` on records with and without
those stages, both cells run once at CPU size (``dtu_val`` added to a
copy of ``BENCHMARK.json``), and ``dtu_val``'s reference control."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, scene_outdoor, spec
from benchmark import work_composite as counts
from benchmark.loops import composite_stream, val
from benchmark.reference import enerf as ref
from benchmark.reference import enerf_composite as rc
from benchmark.work import PEAKS

SEED = 3141592653589


def _resolved(workload, hw, **enerf):
    r = spec.resolve(val.with_cell(spec.load_benchmark()), workload)
    r["config"] = dict(r["config"], image_hw=list(hw),
                       enerf=dict(r["config"]["enerf"], **enerf))
    r["traffic"] = dict(r["traffic"], ring=3, warmup=2, check_frames=3, trace_units=2)
    return r


def _outdoor():
    return _resolved("outdoor_composite", (96, 128), fg_bbox_hw=[64, 32])


def test_param_spec_keys_are_the_ports_state_dict():
    import enerf_tpu_torch as et

    run = harness.Run(spec.resolve(spec.load_benchmark(), "outdoor_composite"), SEED, "cpu")
    model = et.build_model(run.port_config(False), device="cpu")
    e = run.config["enerf"]
    got = {k: tuple(s) for k, s, _, _ in rc.param_spec(run.cascade(False),
                                                       e["num_fg_layers"], e["viewdir_agg"])}
    assert got == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_outdoor_window_moves_and_clamps():
    """At the cell's 768x1024 every seed's ring moves the window and
    clamps it at the frame's bottom edge in some frames and not in others;
    the frames' ``bbox`` is the geometry's."""
    r = spec.resolve(spec.load_benchmark(), "outdoor_composite")
    sc, (H, W) = r["traffic"]["scene"], r["config"]["image_hw"]
    fh, fw = r["config"]["enerf"]["fg_bbox_hw"]
    for seed in (SEED, 2 ** 33 + 5, 7):
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 17])
        phase0 = rng.uniform(0.0, 2.0 * math.pi)
        boxes = [scene_outdoor.frame_geometry(rng, sc, H, W, 3, (fh, fw), k, 16, phase0)["bbox"]
                 for k in range(16)]
        assert len({(b[0], b[1]) for b in boxes}) > 8
        clamped = sum(b[1] == H - fh for b in boxes)
        assert 0 < clamped < 16
        assert all(0 <= b[0] <= W - fw and 0 <= b[1] <= H - fh for b in boxes)
    small = _outdoor()
    frames = scene_outdoor.make_frames(small["config"], small["traffic"], SEED, "cpu", 2)
    rng = np.random.default_rng([SEED & 0xFFFFFFFF, SEED >> 32, len("outdoor_composite")])
    phase0 = rng.uniform(0.0, 2.0 * math.pi)
    rng.uniform(*sc["wall_depth"])
    rng.uniform(0.0, 1.0, size=(3, 3))
    geo = scene_outdoor.frame_geometry(rng, sc, 96, 128, 3, (64, 32), 0, 2, phase0)
    assert frames[0]["bbox"][0, 0].tolist() == geo["bbox"]
    nf = frames[0]["near_far"][0]
    assert 0 < float(nf[0, 0]) < float(nf[0, 1]) and 0 < float(nf[1, 0]) < float(nf[1, 1])


def _counted(fn):
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    by_op = mode.get_flop_counts()["Global"]
    return sum(v for op, v in by_op.items()
               if any(n in str(op) for n in ("convolution", "addmm", ".mm")))


def test_composite_flops_match_flop_counter():
    r = _outdoor()
    run = harness.Run(r, SEED, "cpu")
    cas = run.cascade(False)
    f = scene_outdoor.make_frames(run.config, run.traffic, SEED, "cpu", 1)[0]
    params, stats = ref.split_state(composite_stream.weights(run))
    with torch.no_grad():
        got = _counted(lambda: rc.forward(params, stats,
                                          composite_stream.reference_config(run), f))
    assert got == counts.frame_flops(run.config, cas, 96, 128, 3)


def test_layer_render_counts_at_the_cells_shapes():
    """The heads' and compositing's work at 768x1024, 3 views, a 512x256
    window: 13,060 multiply-adds a sample on 917,504 samples (23.97
    GFLOP); bytes: the fg layer's image table over its window, 3 x 131,072
    x 11 floats, the background's over the frame, 3 x 786,432 x 11, the
    rays of both layers, the fg layer's maps over its window at 256x128
    and the background's at 384x512, rgb, depth and 2 weights a ray:
    173.0 MB, the bound (51.6 us at 3.35 TB/s)."""
    r = spec.resolve(spec.load_benchmark(), "outdoor_composite")
    cfg, cas = r["config"], spec.cascade(r["config"], False)
    assert counts.head_macs(11, False) == (2112, 6720)
    flops = counts.layer_render_flops(cfg, cas, 768, 1024, 3)
    assert flops == 2 * 13060 * (512 * 256 + 768 * 1024)
    nbytes = counts.layer_render_bytes(cfg, cas, 768, 1024, 3)
    assert nbytes == 4 * (3 * 131072 * 11 + 3 * 786432 * 11 + 8 * (131072 + 786432)
                          + 4 * 256 * 128 + 4 * 384 * 512 + 786432 * 6)
    assert nbytes == 173015040
    assert nbytes / PEAKS["hbm_bytes_per_s"] > flops / PEAKS["tf32_flops_per_s"]


NEW = ("stage_ms.cost_reg", "stage_ms.layer_render", "layer_render_roofline",
       "stage_ms.evaluate")


def test_new_readers_with_and_without_their_stages():
    r = spec.resolve(spec.load_benchmark(), "outdoor_composite")
    cfg, cas = r["config"], spec.cascade(r["config"], False)
    work = dict(counts.stages(cas), peaks=PEAKS,
                layer_render_flops=counts.layer_render_flops(cfg, cas, 768, 1024, 3),
                layer_render_bytes=counts.layer_render_bytes(cfg, cas, 768, 1024, 3))
    assert work["cost_reg_stages"] == ["fg_cost_reg_0", "bg_cost_reg_0",
                                       "fg_cost_reg_1", "bg_cost_reg_1"]
    names = set(work["cost_reg_stages"] + work["layer_render_stages"])
    rec = {"units": 2, "work": work,
           "stage_kernel_s": dict({n: 1e-3 for n in names}, **{"val.evaluate": 4e-3})}
    read = {n: spec.load_reader(n).read(rec) for n in NEW}
    assert read["stage_ms.cost_reg"] == pytest.approx(2.0)
    assert read["stage_ms.layer_render"] == pytest.approx(1.5)
    assert read["layer_render_roofline"] == pytest.approx(
        100 * work["layer_render_bytes"] / PEAKS["hbm_bytes_per_s"] / 1.5e-3)
    assert read["stage_ms.evaluate"] == pytest.approx(2.0)
    # the parent's composite marks (no per-layer stages), an untraced run
    parent = dict(rec, stage_kernel_s={n: 1e-3 for n in (
        "feature_net", "fg_0", "bg_0", "fg_1", "bg_1", "composite_1", "frame_end")})
    for bad in (parent, dict(rec, stage_kernel_s=None), dict(rec, units=0), {}):
        for n in NEW:
            assert spec.load_reader(n).read(bad) is None, (n, bad.keys())


@pytest.mark.parametrize("workload, hw, enerf", [
    ("outdoor_composite", (96, 128), {"fg_bbox_hw": [64, 32]}),
    ("dtu_val", (64, 96), {})])
def test_cell_runs_and_checks_at_cpu_size(workload, hw, enerf):
    import time

    r = _resolved(workload, hw, **enerf)
    out = harness.execute(r, SEED, 0.5, False, "cpu", time.perf_counter())
    line = harness.result_line(r, out, False)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["metrics"]["fps"]["value"] > 0
    assert out["state"].attempted >= r["traffic"]["check_frames"]


def test_dtu_val_is_added_to_a_copy_and_its_reference_control_reads():
    bench = spec.load_benchmark()
    added = val.with_cell(bench)
    assert "dtu_val" not in {w["name"] for w in bench["workloads"]}
    assert added["workloads"][-1] == val.CELL
    metrics = spec.cell_metrics(added, "dtu_val")
    assert {m["name"] for m in metrics["end_to_end"]} == {"fps", "setup_s"}
    assert {m["name"] for m in metrics["per_layer"]} == set(val.LISTED_IN[1:]) | {
        "stage_ms.evaluate"}
    r = _resolved("dtu_val", (64, 96))
    numbers = val.reference_control(harness.Run(r, SEED, "cpu"))
    # no TF32 on the CPU: the reference against itself
    assert set(numbers) >= set(r["traffic"]["limits"])
    assert all(v == 0 for v in numbers.values())


def test_the_composite_reference_loads_neither_jax_nor_the_port():
    from test_bench_imports import FORBIDDEN, _loaded

    mods = _loaded("from benchmark import gaps, scene_outdoor, work_composite\n"
                   "from benchmark.reference import enerf_composite\n")
    assert not mods & (FORBIDDEN | {"enerf_tpu_torch"})
