"""The port's examples (`examples/torch_*.py`, the `repro_torch` twins of
the five scripts in `examples/`) run to their end on the CPU at small
arguments, each in a subprocess with its own timeout, so that they keep
up with the package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# script, small arguments, a line its output must hold
CASES = [
    ("torch_quickstart.py", ["--nodes", "5000", "--edges", "20000"],
     "oracle validation: OK"),
    ("torch_bisim_pipeline.py", ["--nodes", "5000", "--edges", "20000",
                                 "--k", "6", "--distributed"],
     "maintenance == rebuild: OK"),
    ("torch_quotient_queries.py", ["--nodes", "1000", "--edges", "4000",
                                   "--oocore"], "reflects the update"),
    ("torch_serve_lm.py", ["--arch", "seamless_m4t_large_v2", "--requests",
                           "4", "--max-new", "6"], "served 4 requests"),
    ("torch_train_lm.py", ["--steps", "30", "--batch", "4", "--seq", "64",
                           "--simulate-failure"], "restarts=1"),
]


@pytest.mark.parametrize("script,args,expect", CASES,
                         ids=[c[0] for c in CASES])
def test_example_runs_on_cpu(tmp_path, script, args, expect):
    extra = []
    if script == "torch_bisim_pipeline.py":
        extra = ["--out", str(tmp_path / "partition.npz")]
    if script == "torch_train_lm.py":
        extra = ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args, *extra], capture_output=True, text=True, cwd=ROOT,
        timeout=120, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert expect in r.stdout, r.stdout[-2000:]
