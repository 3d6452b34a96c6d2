"""Every entry of BENCHMARK.json resolves to its files by name, and a new
cell, configuration or per-layer metric is added by new files alone."""

import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_entry_resolves(bench):
    for c in bench["configs"]:
        assert spec.config_path(c["name"]).is_file()
        assert (spec.ROOT / c["file"]) == spec.config_path(c["name"])
        cfg = spec.load_json(spec.config_path(c["name"]))
        assert cfg["source"] == c["source"]
    for w in bench["workloads"]:
        r = spec.resolve(bench, w["name"])
        for fn in ("setup", "window", "work", "check"):
            assert callable(getattr(r["loop"], fn))
        assert r["traffic"]["limits"]
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]).read)
        assert m["name"] and spec.load_reader(m["name"]).read({}) is None


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(bench, key):
    names = [e["name"] for e in bench[key]]
    assert len(names) == len(set(names))
    for e in bench[key]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = spec.cell_metrics(bench, w["name"])
        names = {m["name"] for m in mine["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert mine["per_layer"]
        assert w["chips"] == 1
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)


def test_bounds_and_window(bench):
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 × 90 s of compiling a cell, 1200 s spare
    R = bench["run_seconds"]
    assert (2 + 14 * 24) * (R + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_new_cell_config_and_metric_are_files_only(tmp_path, bench):
    """In a copy: a new configuration, traffic mix and per-layer metric,
    each a new file, and entries appended to BENCHMARK.json, resolve
    without any file of the benchmark changing."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/enerf_dtu.json").read_text())
    cfg.update(name="enerf_dtu_wide", image_hw=[576, 768])
    (root / "benchmark/configs/enerf_dtu_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/dtu_stream.json").read_text())
    traffic["ring"] = 8
    (root / "benchmark/traffic/dtu_wide_stream.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/stage_ms.depth.py").write_text(
        "def read(rec):\n    s = rec.get('stage_kernel_s') or {}\n"
        "    return s.get('depth_1')\n")
    b = dict(bench)
    b["configs"] = bench["configs"] + [dict(bench["configs"][0], name="enerf_dtu_wide",
                                            file="benchmark/configs/enerf_dtu_wide.json")]
    b["workloads"] = bench["workloads"] + [dict(bench["workloads"][0], name="dtu_wide_stream",
                                                config="enerf_dtu_wide",
                                                traffic="dtu_wide_stream")]
    b["per_layer"] = bench["per_layer"] + [dict(bench["per_layer"][2], name="stage_ms.depth",
                                                workloads=["dtu_wide_stream"])]
    r = spec.resolve(b, "dtu_wide_stream", bench_dir=root / "benchmark")
    assert r["config"]["image_hw"] == [576, 768] and r["traffic"]["ring"] == 8
    assert [m["name"] for m in r["metrics"]["per_layer"]][-1] == "stage_ms.depth"
    reader = spec.load_reader("stage_ms.depth", bench_dir=root / "benchmark")
    assert reader.read({"stage_kernel_s": {"depth_1": 2.0}}) == 2.0
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
