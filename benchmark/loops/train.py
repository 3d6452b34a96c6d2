"""Training steps through ``enerf_tpu_torch.train.create_train_state`` and
``make_train_step``: one state (model, Adam, schedule) built in set-up,
driven from the seed through its first ``checked_steps`` steps through
the window's own call and feed (which the check follows with the
reference: the losses, the first gradient and the first step's change of
the BatchNorm running statistics, the parameters' change over the
steps), then through the window, on a ring of
``ring`` seeded batches resident on the device, batch 1, the MSE loss.
``step_ms`` is the window's seconds over the steps completed in it."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark import compare, scene
from benchmark import work as counts
from benchmark.reference import enerf as ref

BETA1 = 0.9     # Adam's first-moment decay (torch's default, the port's)


@dataclass
class State:
    train_state: object
    step: object
    batches: list
    attempted: int = 0
    failed: int = 0
    extra: dict = field(default_factory=dict)


def _named_params(model):
    return dict(model.named_parameters())


def setup(run) -> State:
    from enerf_tpu_torch.train import create_train_state, make_train_step

    t = run.traffic
    model = run.build_model(train=True)
    cfg = run.port_config(True)
    ts = create_train_state(cfg, model)
    step = make_train_step(cfg, tuple(run.config["image_hw"]))
    run.mark("model")
    batches = scene.make_frames(run.config, t, run.seed, run.device, t["ring"], train=True)
    run.mark("inputs")
    params = _named_params(model)
    start = {k: p.detach().clone() for k, p in params.items()}
    stats0 = _bn_stats(model)
    losses, grads = [], None
    for i in range(t["checked_steps"]):
        ts, stats = step(ts, batches[i])
        losses.append(stats["loss"])
        if i == 0:
            opt = ts.optimizer.state
            grads = {k: (opt[p]["exp_avg"] / (1.0 - BETA1)).clone()
                     for k, p in params.items() if p in opt}
            stats1 = _bn_stats(model)
    after = {k: p.detach().clone() for k, p in params.items()}
    run.mark("checked_steps")
    st = State(ts, step, batches)
    st.extra.update(losses=losses, grads=grads, start=start, after=after,
                    stats=(stats0, stats1), next=t["checked_steps"])
    return st


def _bn_stats(model) -> dict:
    """Copies of the model's BatchNorm running means and variances."""
    return {k: b.detach().clone() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def window(run, st: State, seconds=None, units=None, hook=None) -> dict:
    ring = len(st.batches)
    k = 0
    i = st.extra["next"]
    t0 = time.perf_counter()
    while (k < units) if units is not None else (time.perf_counter() - t0 < seconds):
        if hook:
            hook("step_start")
        st.train_state, _ = st.step(st.train_state, st.batches[i % ring],
                                    phase_hook=hook)
        if hook:
            hook("step_end")
        k += 1
        i += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    st.extra["next"] = i
    st.attempted = k
    return {"step_ms": elapsed / k * 1e3, "units": k, "seconds": elapsed}


def work(run, st: State) -> dict:
    cas = run.cascade(True)
    H, W = run.config["image_hw"]
    S = run.config["train_source_views"]
    rays = {i: float(st.batches[0][f"rays_{i}"].shape[1])
            for i in range(cas["num"]) if cas["render_if"][i]}
    return {"step_flops": counts.step_flops(cas, H, W, S, rays),
            "peaks": counts.PEAKS}


def _opt(run) -> dict:
    t = run.config["train"]
    return dict(t, scheduler=t["scheduler"])


def check(run, st: State):
    ex = st.extra
    losses = [float(x) for x in ex["losses"]]
    n = run.traffic["checked_steps"]
    batches = st.batches[:n]
    st.train_state = st.step = None
    if run.cuda:
        torch.cuda.empty_cache()
    with compare.precision(False):
        r_losses, r_grads, r_after, r_stats = ref.train_steps(
            run.weights(True), run.cascade(True), _opt(run), batches)
    numbers = compare.train_numbers(losses, ex["grads"], ex["start"],
                                    ex["after"], r_losses, r_grads, r_after,
                                    ex["stats"], r_stats)
    st.extra["numbers"] = numbers
    checks = compare.with_limits(numbers, run.traffic["limits"])
    st.failed = sum(1 for _, v, lim in checks if not v <= lim)
    return checks
