"""Run one cell of ``BENCHMARK.json`` once and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and the compared numbers under ``checks``); the compared
numbers and their limits are also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "4")

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_env(ROOT)
    sys.exit(harness.main(sys.argv[1:], T_START))
