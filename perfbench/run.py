"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs a CUDA card (exit 2 without one).
See ``perfbench/bench.py``.
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, heads the path: `perfbench` is a
# package there
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], STARTED))
