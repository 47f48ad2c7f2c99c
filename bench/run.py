"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload graph500-s25.k8 --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (`BENCHMARK.json`).  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``); the last lines of
standard error are the compared numbers beside their limits.  Exits
non-zero, with no result, without enough cards or if JAX or the JAX
package was loaded.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for `bench`) and `src` (the program) in place of
# this directory, whose module names must not shadow others
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
