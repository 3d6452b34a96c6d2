"""Where the benchmark finds each thing it runs, by the names in
``BENCHMARK.json``: a configuration in ``configs/<config>.json``, a
traffic mix in ``traffic/<cell>.json`` (which names its loop), a loop in
``loops/<loop>.py`` and a per-layer metric's reader in
``metrics/<metric>.py``. A later cell, configuration or metric is a new
file under these names; no file here changes for it."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def config_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "configs" / f"{name}.json"


def traffic_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def loop_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "loops" / f"{name}.py"


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_loop(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(loop_path(name, bench_dir), f"_bench_loop_{name}")


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _module(metric_path(name, bench_dir),
                   "_bench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str) -> Dict[str, list]:
    """The cell's end-to-end and per-layer metric entries: those without a
    ``workloads`` key, or whose ``workloads`` lists the cell."""
    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def cascade(cfg: dict, train: bool) -> dict:
    """The cascade a configuration runs: its ``cas_config`` in training,
    with its ``eval_overrides`` laid over it in eval."""
    cas = dict(cfg["cas_config"])
    if not train:
        cas.update(cfg.get("eval_overrides", {}))
    return cas


def resolve(bench: dict, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Everything one run of ``workload`` reads: the cell, its
    configuration and traffic dicts, and its loop module."""
    c = cell(bench, workload)
    cfg = load_json(config_path(c["config"], bench_dir))
    traffic = load_json(traffic_path(c["traffic"], bench_dir))
    traffic.setdefault("name", c["traffic"])
    return {"cell": c, "config": cfg, "traffic": traffic,
            "loop": load_loop(traffic["loop"], bench_dir),
            "metrics": cell_metrics(bench, workload)}
