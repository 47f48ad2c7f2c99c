"""The comparison's readings on the card at a cell's own size, several
seeds in one process: the control (the program's own counting mode,
``multiset``, in place of the configuration's set semantics, the
guarantee it states) and, with ``--sound``, the program as configured.

    python3 bench/control.py --workload graph500-s25.k8 --seeds 1 2 3 \
        --seconds 3 [--sound]

One JSON line a run: seed, mode, ``correct`` and the compared numbers.
The benchmark's own runs never run this.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402

from bench import harness  # noqa: E402

CONTROL_MODE = "multiset"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sound", action="store_true",
                   help="also run the program as configured on each seed")
    args = p.parse_args(argv)
    modes = [None, CONTROL_MODE] if args.sound else [CONTROL_MODE]
    for seed in args.seeds:
        for mode in modes:
            r = harness.run(args.workload, seed, args.seconds, False,
                            mode=mode)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "mode": mode or "configured", "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                "checks": r["checks"], "setup_parts": r["setup_parts"]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
