"""A copy of the benchmark in a temporary directory, with toy cells small
enough for the CPU: the harness finds them as it finds the real ones."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# toy configuration: (the real one it copies, the sizes it changes)
TOYS = {"kr-a": ("graph500-s25", {"scale": 10}),
        "kr-b": ("graph500-s25", {"scale": 8})}
CELLS = {"kr-a.k8": ("kr-a", "k8"), "kr-b.k2": ("kr-b", "k2")}


def toy_root(tmp: Path) -> Path:
    """``tmp`` holding `BENCHMARK.json` with the toy cells and a copy of
    ``bench/`` with their configurations."""
    shutil.copytree(REPO / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for toy, (real, sizes) in TOYS.items():
        cfg = json.loads((REPO / "bench" / "configs" / f"{real}.json")
                         .read_text())
        cfg.update(name=toy, **sizes)
        (tmp / "bench" / "configs" / f"{toy}.json").write_text(
            json.dumps(cfg))
    spec["workloads"] = [{"name": cell, "config": cfg, "traffic": traffic,
                          "chips": 1, "why": "toy"}
                         for cell, (cfg, traffic) in CELLS.items()]
    for m in spec["per_layer"]:
        m["workloads"] = list(CELLS)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
