"""The second control of ``correct``, for a cell whose loop has a
``reference_control``: the reference computed in TF32 (the nearest
precision below the configurations' float32) in the program's place,
against the reference in float32, on each seed's frames; with the
``correct`` those numbers would give under the traffic's limits. A cell
that ``BENCHMARK.json`` does not hold is named by its loop's ``CELL``.

    python3 benchmark/control_reference.py --workload <cell> --seeds <n> ...

Prints one JSON line a seed, and appends them to the file ``--out``
names, if any.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "4")

from benchmark import compare, harness, spec  # noqa: E402


def resolve(workload: str) -> dict:
    bench = spec.load_benchmark()
    if not any(w["name"] == workload for w in bench["workloads"]):
        loop = spec.load_json(spec.traffic_path(workload))["loop"]
        bench = spec.load_loop(loop).with_cell(bench)
    return spec.resolve(bench, workload)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", help="a JSON-lines file the readings are appended to")
    args = ap.parse_args()
    harness.cache_env(ROOT)
    resolved = resolve(args.workload)
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        run = harness.Run(resolved, seed, "cuda")
        numbers = resolved["loop"].reference_control(run)
        checks = compare.with_limits(numbers, resolved["traffic"]["limits"])
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "reading": "control_reference", "numbers": numbers,
                           "correct": harness.checks_ok(checks)})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
