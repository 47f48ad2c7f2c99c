"""The harness end to end on the CPU at toy sizes (the look for a card
skipped): a sound run is correct, and the control and each fault that a
build can have make ``correct`` false.  The per-layer readers on a
made-up trace, and the command's refusal without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, profview, registry
from bench.tests.toy import CELLS, REPO, toy_root
from repro_torch.core import partition


@pytest.fixture
def root(tmp_path):
    return toy_root(tmp_path)


def run(root, cell, **kw):
    kw.setdefault("trace", False)
    return harness.run(cell, 2 ** 31 + 101, 0.05, device="cpu", root=root,
                       **kw)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, cell, trace):
    got = run(root, cell, trace=trace)
    assert got["correct"] and got["failed"] == 0, got["checks"]
    assert got["attempted"] >= 1
    assert list(got)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"] for c in got["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        got["device"])
    if trace:
        assert "loop.dispatches" in got["metrics"] and "breakdown" in got
        assert {"busy_s", "window_s"} <= set(got["device"])
    else:
        assert set(got["metrics"]) == {"build_ms", "device_bytes_per_edge",
                                       "setup_s"}
        assert got["metrics"]["setup_s"]["value"] > 0
        assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_fails(root, cell):
    """The program's own counting mode in place of the configuration's set
    semantics: the guarantee broken, the comparison says so."""
    got = run(root, cell, mode="multiset")
    assert not got["correct"] and got["failed"] == got["attempted"]
    assert got["checks"]["partition_gap"]["value"] > 0


def _unchanged(pid0, src, dst, elabel, pid_prev, **kw):
    """A step that returns its state unchanged."""
    n = torch.unique(pid_prev).numel()
    zero = torch.zeros(pid_prev.numel(), dtype=torch.int64)
    return pid_prev, torch.tensor(n, dtype=torch.int32), zero, zero


def _half_batch(step):
    def half(pid0, src, dst, elabel, pid_prev, **kw):
        """Half of the edges left out."""
        h = src.numel() // 2
        return step(pid0, src[:h], dst[:h], elabel[:h], pid_prev, **kw)
    return half


def _altered(build):
    def altered(*args, **kw):
        """One answer altered where it is produced: the last node moved to
        the first node's block at the deepest level."""
        res = build(*args, **kw)
        res.pids = np.array(res.pids)
        res.pids[-1, -1] = res.pids[-1, 0] if res.pids[-1, -1] != res.pids[
            -1, 0] else res.pids[-1].max() + 1
        return res
    return altered


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_faults_fail(root, cell, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(partition, "bisim_step", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(partition, "bisim_step",
                            _half_batch(partition.bisim_step))
    else:
        monkeypatch.setattr(partition, "build_bisim",
                            _altered(partition.build_bisim))
    got = run(root, cell)
    assert not got["correct"], got["checks"]
    assert got["failed"] >= 1


def view(**kw):
    base = dict(builds=2, window=(0.0, 1000.0), device=[
        ("Memcpy HtoD (Pageable -> Device)", 0.0, 100.0),
        ("void cub::DeviceRadixSortOnesweepKernel<...>", 100.0, 300.0),
        ("void fold_flat<4>(Fold)", 300.0, 340.0),
        ("void at::native::elementwise_kernel<...>", 340.0, 400.0),
        ("Memset (Device)", 400.0, 410.0),
        ("Memcpy DtoH (Device -> Pageable)", 600.0, 700.0),
        ("void fold_flat<4>(Fold)", 700.0, 740.0),
        ("Memcpy HtoD (Pageable -> Device)", 1200.0, 1300.0)],
        host=[(profview.BUILD_RANGE, 0.0, 1000.0),
              ("aten::to", 400.0, 600.0),
              ("cudaMemcpyAsync", 420.0, 590.0)],
        events=[{"name": "build.dispatch"}] * 6 + [{"name": "build.sync"}],
        fold_calls=[(1000, 100), (1000, 100)], fold_launches=2)
    base.update(kw)
    return profview.TraceView(**base)


def read(name, v):
    return registry.metric_reader(name)(v)


def test_readers_on_a_made_up_trace():
    v = view()
    assert read("loop.dispatches", v) == 3
    assert read("copy.h2d_ms", v) == pytest.approx(0.05)  # 100 us / 2
    assert read("copy.d2h_ms", v) == pytest.approx(0.05)
    assert read("signatures.sort_ms", v) == pytest.approx(0.1)
    assert read("signatures.other_ms", v) == pytest.approx(0.03)
    fold_s = 80e-6
    share = 100 * 2 * (13 * 1000 + 8 * 100) / 3.35e12 / fold_s
    assert read("fold_flat_roofline", v) == pytest.approx(share)
    # busy 0..410 and 600..740 of the 1000 us window
    assert read("device.idle_share", v) == pytest.approx(45.0)
    assert v.busy_s() == pytest.approx(550e-6)
    b = v.breakdown()
    assert b["device_ops"][0][0].startswith("void cub::DeviceRadixSort")
    assert b["idle_gaps"] == [["host (python) (x1)", pytest.approx(260e-6)],
                              ["aten::to > cudaMemcpyAsync (x1)",
                               pytest.approx(190e-6)]]


def test_readers_return_nothing_without_their_activity():
    empty = view(device=[], events=[], fold_calls=[], fold_launches=0)
    for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]:
        assert read(m["name"], empty) is None
    # bytes and time of different calls: no share
    assert read("fold_flat_roofline", view(fold_launches=3)) is None
    assert read("fold_flat_roofline", view(fold_calls=[(1000, 100)])) is None


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    out = subprocess.run(
        [sys.executable, str(REPO / "bench" / "run.py"), "--workload",
         "graph500-s25.k8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden(["jax.numpy", "repro_torch.core", "torch"]) == [
        "jax"]
    assert harness.forbidden(["repro.core", "flax", "jaxlib"]) == [
        "flax", "jaxlib", "repro"]
    assert harness.forbidden(["repro_torch", "jaxtyping"]) == []


def test_other_graph_for_the_reference_is_not_correct(root, monkeypatch):
    """Where the graph made again from the seed is not the program's, the
    run compares nothing and is not correct."""
    calls = iter(range(1000))
    monkeypatch.setattr(harness, "fingerprint", lambda cols: next(calls))
    got = run(root, "kr-a.k8")
    assert not got["correct"]
    assert all(c["value"] == 0 for c in got["checks"].values())
