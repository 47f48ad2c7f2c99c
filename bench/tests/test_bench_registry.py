"""`BENCHMARK.json` and the files it names: each configuration, traffic
mix, graph family and per-layer metric is found by name, a new one is
found from new files alone, and the file keeps the contract's form."""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest

from bench import harness, registry
from bench.tests.toy import REPO, toy_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_by_name(cell):
    c = registry.cell(cell)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                    if w["name"] == cell)
    assert callable(registry.generator(c.config["generator"]).generate)
    assert c.traffic["k"] >= 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(registry.metric_reader(metric))


def test_every_end_to_end_metric_is_computed():
    assert {m["name"] for m in SPEC["end_to_end"]} <= set(harness.END_TO_END)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such.cell")
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no.such_metric")


def test_contract_form():
    """Keys, names, units and limits as the benchmark's contract fixes
    them."""
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][1] == "bench/run.py"
    assert all((REPO / p).is_dir() for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(0 < len(c[k]) <= 200 and "\n" not in c[k]
                   for k in ("why", "source"))
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
    assert {w["config"] for w in SPEC["workloads"]} == configs
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {
            w["name"] for w in SPEC["workloads"]}
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for name in [w["name"] for w in SPEC["workloads"]] + names:
        assert NAME.match(name)


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus new entries run with no file of the benchmark edited."""
    root = toy_root(tmp_path)
    before = _digest(root / "bench")
    bench = root / "bench"
    cfg = json.loads((bench / "configs" / "kr-a.json").read_text())
    cfg.update(name="kr-new", scale=9)
    (bench / "configs" / "kr-new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "k3.json").write_text(json.dumps(
        {"name": "k3", "k": 3, "early_stop": False, "loop": "closed",
         "clients": 1}))
    (bench / "metrics" / "loop.syncs.py").write_text(
        "def read(view):\n"
        "    n = sum(e['name'] == 'build.sync' for e in view.events)\n"
        "    return n / view.builds if n else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "kr-new.k3", "config": "kr-new",
                              "traffic": "k3", "chips": 1, "why": "new"})
    spec["per_layer"].append({"name": "loop.syncs", "unit": "count",
                              "better": "lower", "source": "program_counter",
                              "layer": "build loop", "moves": "build_ms",
                              "workloads": ["kr-new.k3"]})
    for m in spec["per_layer"]:
        if m["name"] == "loop.dispatches":
            m["workloads"].append("kr-new.k3")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    got = harness.run("kr-new.k3", 3, 0.05, True, device="cpu", root=root)
    assert got["correct"], got["checks"]
    # no early stop: iteration 0 and three steps a build
    assert got["metrics"]["loop.dispatches"]["value"] == 4
    assert got["metrics"]["loop.syncs"]["value"] >= 2
    after = _digest(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
