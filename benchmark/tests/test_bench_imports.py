"""What the harness and the reference load, by whole top-level module
names: never JAX or the JAX package (``enerf_tpu``, whose name begins the
port's ``enerf_tpu_torch``), and the reference not the port either."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "enerf_tpu"}


def _loaded(code: str) -> set:
    prog = ("import sys, json\nsys.path.insert(0, %r)\nsys.path.insert(0, %r)\n%s\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(ROOT / "benchmark" / "tests"), code))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _loaded(
        "import time, torch\ntorch.set_num_threads(2)\n"
        "from conftest import small\nfrom benchmark import harness\n"
        "for w in ('dtu_stream', 'zjumocap_interactive', 'dtu_train'):\n"
        "    out = harness.execute(small(w, ring=3, pool=2), 7, 0.2, False, 'cpu',\n"
        "                          time.perf_counter())\n"
        "    assert harness.forbidden_modules() == []\n")
    assert not mods & FORBIDDEN
    assert "enerf_tpu_torch" in mods and "benchmark" in mods


def test_the_reference_loads_neither_jax_nor_the_port():
    mods = _loaded("from benchmark import compare, scene, weights, work, spec\n"
                   "from benchmark.reference import enerf\n")
    assert not mods & (FORBIDDEN | {"enerf_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    import enerf_tpu_torch  # noqa: F401
    from benchmark import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "enerf_tpu_torchx", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "enerf_tpu.models", types.ModuleType("m"))
    assert harness.forbidden_modules() == ["enerf_tpu", "jax"]
