"""Shared set-up of the benchmark's own tests: the repository root on the
path, and cells at sizes a CPU test run holds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402

# the smallest frames whose volumes survive the 3D U-Nets' three halvings:
# DTU 64x96 (level 0 8x12, level 1 32x48), the performer 64x64 with a
# window that covers its mask there
SMALL_HW = {"enerf_dtu": (64, 96), "enerf_zjumocap": (64, 64)}
SMALL_WINDOW = [64, 48]


def small(workload: str, **traffic) -> dict:
    """``spec.resolve`` of ``workload`` cut to CPU size: small frames, a
    ring or pool of 3, ``traffic`` laid over its traffic file."""
    bench = spec.load_benchmark()
    cfg_name = spec.cell(bench, workload)["config"]
    r = spec.resolve(bench, workload)
    r["config"] = dict(r["config"], image_hw=list(SMALL_HW[cfg_name]))
    if "mask_window_hw" in r["config"]["enerf"]:
        r["config"] = dict(r["config"], enerf=dict(r["config"]["enerf"],
                                                   mask_window_hw=SMALL_WINDOW))
    t = dict(r["traffic"], trace_units=2)
    for k in ("ring", "pool"):
        if k in t:
            t[k] = 3
    t.update(traffic)
    r["traffic"] = t
    return r


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
