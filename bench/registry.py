"""Finds every piece of the benchmark by the name `BENCHMARK.json` gives
it, so that a cell, a configuration, a traffic mix or a per-layer metric
is added by adding files and entries, never by editing a file:

* ``bench/configs/<config>.json``: a configuration (its ``generator``
  names the graph family);
* ``bench/gen/<generator>.py``: a graph family, with ``generate(cfg,
  seed, device)``;
* ``bench/traffic/<traffic>.json``: a traffic mix;
* ``bench/metrics/<metric>.py``: a per-layer metric, with ``read(view)``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list   # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    return json.loads(path.read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "bench" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "bench" / "traffic" / f"{name}.json")


def generator(name: str, root: Path = ROOT):
    return _module(root / "bench" / "gen" / f"{name}.py", f"bench_gen_{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(view)`` of the per-layer metric ``name``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    return _module(path, "bench_metric_" + name.replace(".", "_")
                   .replace("-", "_")).read


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    return Cell(name, config(w["config"], root), traffic(w["traffic"], root),
                w["chips"],
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])
