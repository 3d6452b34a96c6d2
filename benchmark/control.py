"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card (set-up is most of a run's time):

- the program's numbers over ``--seeds``: the whole run (set-up, a short
  window of ``--seconds``, the check against the reference), as
  ``benchmark/run.py`` makes it;
- the control's, on the first ``--control-seeds`` of them: the same run
  with the program's own TF32 path switched on (cuDNN's and cuBLAS'
  ``allow_tf32``, the nearest precision below the configurations'
  float32 with TF32 off), checked against the reference in float32, with
  the ``correct`` its result line would print; on ``--cudnn-seeds`` also
  the port's default, TF32 in cuDNN's convs alone;
- for a train cell also the fault of half the batch left out (the loss's
  mean over the first half of each level's rays), planted in the
  reference, and the program's first step against itself. A step that
  returns its state unchanged needs no run: it reads 1 by the update
  numbers (``update_norm_gap*``, ``update_cos_gap``);
- with ``--look``, for a train cell, why its gradient numbers swing
  (``look``).

    python3 benchmark/control.py --workload <cell> --seeds <n> ... [--seconds 1]

Prints one JSON line a seed and reading, and appends them to the file
``--out`` names, if any.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "4")

from benchmark import compare, harness, spec  # noqa: E402
from benchmark.reference import enerf as ref  # noqa: E402

import torch  # noqa: E402


def train_readings(run, st) -> dict:
    """The fault of half the batch, planted in the reference, against the
    reference; and the program's first step against itself."""
    from benchmark.loops.train import _opt

    n = run.traffic["checked_steps"]
    batches = st.batches[:n]
    start = run.weights(True)
    cas, opt = run.cascade(True), _opt(run)
    with compare.precision(False):
        r = ref.train_steps(start, cas, opt, batches)
        half = ref.train_steps(start, cas, opt, batches, keep=0.5)
    params = {k: v for k, v in start.items() if k in r[1]}
    stats0 = {k: v for k, v in start.items() if k in r[3]}
    return {"half_batch": compare.train_numbers(
                half[0], half[1], params, half[2], r[0], r[1], r[2],
                (stats0, half[3]), r[3]),
            "program_self": program_self(run, st)}


def look(run, st, f64: bool) -> dict:
    """Why a gradient number swings: the reference's first step against
    itself on inputs moved by rounding (each camera matrix and image × (1 ±
    2^-23), seeded), and with ``f64`` the reference in float32 against
    float64. Both read only the first step."""
    from benchmark.loops.train import _opt

    start = run.weights(True)
    cas, opt = run.cascade(True), _opt(run)
    batch = st.batches[0]
    with compare.precision(False):
        r = ref.train_steps(start, cas, opt, [batch])
        gen = torch.Generator(device=batch["src_inps"].device).manual_seed(run.seed)
        moved = {k: (v * (1 + 2.0 ** -23 * torch.randint(-1, 2, v.shape, generator=gen,
                                                         device=v.device))
                     if k in ("src_exts", "src_ixts", "tar_ext", "tar_ixt", "src_inps")
                     else v) for k, v in batch.items()}
        nudged = ref.train_steps(start, cas, opt, [moved])
        if f64:
            b64 = {k: v.double() for k, v in batch.items()}
            r64 = ref.train_steps(start, cas, opt, [b64], dtype=torch.float64)
    params = {k: v for k, v in start.items() if k in r[1]}
    pairs = [("nudged", nudged, r)] + ([("float64", r, r64)] if f64 else [])
    out = {}
    for name, got, want in pairs:
        got, want = _float32(got), _float32(want)
        nums = compare.train_numbers(got[0], got[1], params, got[2], *want)
        out[name] = {k: v for k, v in nums.items() if k.startswith(("loss", "grad"))}
        norms = {k: (float(got[1][k].double().norm()),
                     float(want[1][k].double().norm())) for k in want[1]}
        med = sorted(w for _, w in norms.values())[len(norms) // 2]
        out[name]["worst_leaf"] = max(norms, key=lambda k: abs(
            norms[k][0] - norms[k][1]) / max(norms[k][1], med))
    return out


def _float32(res):
    """A ``ref.train_steps`` result with its tensors in float32."""
    losses, grads, after, _ = res
    return (losses, {k: v.float() for k, v in grads.items()},
            {k: v.float() for k, v in after.items()})


def program_self(run, st) -> dict:
    """The program's first step taken again from the same weights on the
    same batch, against the run's own first step: how far the program
    reads from itself (cuDNN's default algorithms are not deterministic)."""
    from benchmark.loops.train import BETA1
    from enerf_tpu_torch.train import create_train_state, make_train_step

    model = run.build_model(train=True)
    cfg = run.port_config(True)
    ts = create_train_state(cfg, model)
    step = make_train_step(cfg, tuple(run.config["image_hw"]))
    ts, stats = step(ts, st.batches[0])
    opt = ts.optimizer.state
    grads = {k: opt[p]["exp_avg"] / (1.0 - BETA1)
             for k, p in model.named_parameters() if p in opt}
    first = st.extra["grads"]
    keys = sorted(first)
    loss0 = float(st.extra["losses"][0])
    return {"loss_rel.1": abs(float(stats["loss"]) - loss0) / abs(loss0),
            "grad_norm_gap": compare._leaf_gaps(grads, first, keys),
            "grad_norm_gap.median": compare._median_gap(grads, first, keys),
            "grad_norm_gap.total": compare._total_gap(grads, first, keys)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seeds", type=int, default=12,
                    help="how many of the seeds also read the control")
    ap.add_argument("--cudnn-seeds", type=int, default=3,
                    help="how many of those also read the port's default "
                         "path: TF32 in cuDNN's convs only")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="train: how many seeds also read the half-batch "
                         "fault and the program against itself")
    ap.add_argument("--look", type=int, default=0,
                    help="train: how many seeds also read the reference on "
                         "nudged inputs")
    ap.add_argument("--f64", action="store_true",
                    help="train: the first seed's look also runs the "
                         "reference in float64")
    ap.add_argument("--out", help="a JSON-lines file the readings are "
                                   "appended to")
    args = ap.parse_args()
    harness.cache_env(ROOT)

    resolved = spec.resolve(spec.load_benchmark(), args.workload)
    sink = open(args.out, "a") if args.out else None
    train = resolved["traffic"]["loop"] == "train"
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        res = harness.execute(resolved, seed, args.seconds, False, "cuda", t0)
        run, st = res["run"], res["state"]
        rows = [{"workload": args.workload, "seed": seed, "reading": "program",
                 "numbers": st.extra["numbers"], "setup_s": res["setup_s"],
                 "e2e": res["e2e"]}]
        if train and i < args.look:
            for name, nums in look(run, st, f64=args.f64 and i == 0).items():
                rows.append({"workload": args.workload, "seed": seed,
                             "reading": "look_" + name, "numbers": nums})
        if train and i < args.fault_seeds:
            for name, nums in train_readings(run, st).items():
                rows.append({"workload": args.workload, "seed": seed,
                             "reading": name, "numbers": nums})
        if i < args.control_seeds:
            paths = [("control", True)]
            if i < args.cudnn_seeds:
                paths.append(("control_cudnn", (False, True)))
            for name, tf32 in paths:
                del run, st, res
                torch.cuda.empty_cache()
                res = harness.execute(resolved, seed, args.seconds, False, "cuda",
                                      time.perf_counter(), tf32=tf32)
                run, st = res["run"], res["state"]
                line = harness.result_line(resolved, res, False)
                rows.append({"workload": args.workload, "seed": seed,
                             "reading": name, "numbers": st.extra["numbers"],
                             "correct": line["correct"], "tf32": res["device"]["tf32"]})
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        del run, st, res
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    bad = harness.forbidden_modules()
    if bad:
        print(f"control: loaded {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
