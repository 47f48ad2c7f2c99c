import sys
from pathlib import Path

# the program lives in the checkout's `src`, as `bench/run.py` finds it
SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)
