"""The control comes out not correct: a run of the cell with the program's
own TF32 path switched on (cuDNN's and cuBLAS' ``allow_tf32``, the
precision just below the configurations' float32 with TF32 off), checked
against the reference in float32, prints ``correct: false``; so does the
reference with half of the batch left out of the train loss. TF32 exists
only on the card, so this runs there (``-m cuda``), at the cells' own
sizes on two frames or steps; ``benchmark/control.py`` reads the same on
more seeds."""

import time

import pytest
import torch

from benchmark import harness, spec

SEEDS = (11, 2 ** 31 + 5)


def _resolved(workload: str) -> dict:
    r = spec.resolve(spec.load_benchmark(), workload)
    r["traffic"] = dict(r["traffic"], check_frames=2)
    return r


def _correct(workload: str, seed: int, tf32: bool) -> bool:
    r = _resolved(workload)
    out = harness.execute(r, seed, 0.5, False, "cuda", time.perf_counter(), tf32=tf32)
    assert out["device"]["tf32"] == {"cuda_matmul": tf32, "cudnn": tf32}
    return harness.result_line(r, out, False)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dtu_stream", "zjumocap_interactive",
                                      "zjumocap_stream", "dtu_train"])
def test_the_programs_tf32_path_fails(workload):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control runs only on a CUDA card")
    for seed in SEEDS:
        assert _correct(workload, seed, tf32=False)
        assert not _correct(workload, seed, tf32=True)


@pytest.mark.cuda
def test_half_the_batch_fails_in_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("the fault is read on a CUDA card")
    from benchmark import control

    for seed in SEEDS:
        r = _resolved("dtu_train")
        out = harness.execute(r, seed, 0.5, False, "cuda", time.perf_counter())
        nums = control.train_readings(out["run"], out["state"])["half_batch"]
        assert any(nums[k] > lim for k, lim in r["traffic"]["limits"].items()), nums
