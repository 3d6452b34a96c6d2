"""A run with its timed path broken underneath comes out not correct: the
chip test skipped, the rest of the run driven on the CPU at a small size,
once for each fault the cells can have (an answer, a frame's colour,
altered where it is produced; a train step that returns its state unchanged; half of the
batch left out of the loss, the mean over the rest). The cells run on
one chip, so there is no exchange between chips to leave out."""

import time

import pytest
import torch

import enerf_tpu_torch
import enerf_tpu_torch.train as port_train
import enerf_tpu_torch.train.step as port_step
from benchmark import harness
from conftest import small

SEED = 2718281828459


def _correct(workload, **traffic) -> bool:
    r = small(workload, **traffic)
    out = harness.execute(r, SEED, 0.3, False, "cpu", time.perf_counter())
    return harness.result_line(r, out, False)["correct"]


@pytest.mark.parametrize("workload", ["dtu_stream", "zjumocap_interactive",
                                      "zjumocap_stream"])
def test_an_altered_answer_fails(monkeypatch, workload):
    assert _correct(workload)
    real = enerf_tpu_torch.render
    calls = []

    def altered(model, batch, **kw):
        out = real(model, batch, **kw)
        calls.append(1)
        if len(calls) % 2 == 0:     # every other frame: its colour 0.01 off
            key = [k for k in out if k.startswith("rgb_level")][-1]
            out[key] = torch.where(out[key] != 0, out[key] + 0.01, out[key])
        return out

    monkeypatch.setattr(enerf_tpu_torch, "render", altered)
    assert not _correct(workload)


def test_a_sound_train_step_passes():
    assert _correct("dtu_train")


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    real = port_train.make_train_step

    def frozen_factory(*a, **kw):
        step = real(*a, **kw)

        def frozen(state, batch, phase_hook=None):
            before = {k: p.detach().clone()
                      for k, p in state.model.named_parameters()}
            state, stats = step(state, batch, phase_hook)
            with torch.no_grad():
                for k, p in state.model.named_parameters():
                    p.copy_(before[k])
            return state, stats
        return frozen

    monkeypatch.setattr(port_train, "make_train_step", frozen_factory)
    assert not _correct("dtu_train")


def test_half_the_batch_left_out_fails(monkeypatch):
    real = port_step.compute_loss

    def half(output, batch, *a, **kw):
        output, batch = dict(output), dict(batch)
        for k in list(output):
            if k.startswith("rgb_level"):
                i = k[len("rgb_level"):]
                n = output[k].shape[1] // 2
                output[k] = output[k][:, :n]
                batch[f"rgb_{i}"] = batch[f"rgb_{i}"][:, :n]
        return real(output, batch, *a, **kw)

    monkeypatch.setattr(port_step, "compute_loss", half)
    assert not _correct("dtu_train")
