"""The in-memory build's spans, copy counters and per-level device times
(`repro_torch.obs`), and their image on the torch profiler's clock.

On the CPU: the spans nest under ``build.bisim``, each has one profiler
range of its name while the profiler records and none while no tracer
is installed, the copy counters equal the bytes copied, and tracing
changes no output.  The ``gpu`` case checks the CUDA-event level times
on the card."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import build_bisim  # noqa: E402
from repro_torch.core import partition  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402

CHILDREN = {"build.upload", "build.prepare", "build.iteration",
            "build.drain", "build.fetch", "build.stores"}


def _graph():
    return gen.powerlaw_graph(150, 700, 3, 2, seed=5)


def _traced(graph, k=6, profiled=True, **kw):
    """(result, tracer, the profiler's host ranges named build.*)."""
    with obs.tracing() as tracer:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                res = build_bisim(graph, k, device="cpu", **kw)
        else:
            res, prof = build_bisim(graph, k, device="cpu", **kw), None
    ranges = ([e for e in prof.events() if e.name.startswith("build.")]
              if prof is not None else [])
    return res, tracer, ranges


@pytest.mark.parametrize("with_store", [False, True])
def test_spans_nest_and_mirror_the_profiler(with_store):
    res, tracer, ranges = _traced(_graph(), with_store=with_store)
    top = tracer.find("build.bisim")
    assert len(top) == 1 and top[0]["parent"] is None
    assert top[0]["attrs"] == {
        "nodes": 150, "edges": _graph().num_edges, "k": 6, "mode": "sorted",
        "path": "staged" if with_store else "fused"}
    names = {s["name"] for s in tracer.spans} - {"build.bisim"}
    want = CHILDREN if with_store else CHILDREN - {"build.stores"}
    assert names == want
    for s in tracer.spans:
        if s["name"] != "build.bisim":
            assert s["parent"] == "build.bisim" and s["depth"] == 1
            inside = top[0]["ts"] <= s["ts"] <= s["ts"] + s["dur"] <= (
                top[0]["ts"] + top[0]["dur"])
            assert inside, s["name"]
    # one profiler range a span, nested as the spans are
    by_name = {}
    for e in ranges:
        by_name[e.name] = by_name.get(e.name, 0) + 1
        if e.name != "build.bisim":
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == "build.bisim"
    assert by_name == {n: len(tracer.find(n)) for n in names | {"build.bisim"}}
    assert res.k_effective >= 1


def test_iteration_spans_carry_each_dispatched_level():
    res, tracer, _ = _traced(_graph(), k=8, sync_every=3)
    levels = [s["attrs"]["level"] for s in tracer.find("build.iteration")]
    steps = [e["attrs"]["iteration"]
             for e in tracer.find_events("build.dispatch")
             if e["attrs"]["what"] == "step"]
    assert levels == [0] + steps
    # dispatched past the fixpoint, then trimmed from the result
    assert res.converged_at is not None
    assert len(levels) > res.k_effective + 1
    # no card: no CUDA-event level times
    assert not tracer.find_events("build.level")


def test_copy_counters_equal_the_bytes_copied():
    g = _graph()
    res, tracer, _ = _traced(g, sync_every=1)
    (up,) = tracer.find("build.upload")
    assert up["attrs"]["bytes"] == 0  # the CPU route aliases the columns
    (fetch,) = tracer.find("build.fetch")
    assert fetch["attrs"]["bytes"] == res.pids.nbytes
    drains = tracer.find("build.drain")
    assert [d["attrs"]["bytes"] for d in drains] == [
        8 * d["attrs"]["batched"] for d in drains]
    copies = tracer.find_events("build.copy")
    assert [(e["attrs"]["what"], e["attrs"]["to"]) for e in copies] == (
        [("upload", "device")] + [("drain", "host")] * len(drains)
        + [("history", "host")])
    assert [e["attrs"]["bytes"] for e in copies] == (
        [0] + [d["attrs"]["bytes"] for d in drains] + [res.pids.nbytes])
    # every drained scalar pair is a level: iteration 0 and each step
    assert sum(d["attrs"]["batched"] for d in drains) == len(
        tracer.find("build.iteration"))


def test_upload_counts_the_columns_where_they_are_copied():
    """Off the CPU the upload counts the columns' bytes (``meta`` tensors
    stand in for a card's)."""
    g = _graph()
    with obs.tracing() as tracer:
        cols = partition._upload(g, torch.device("meta"))
    assert [c.device.type for c in cols] == ["meta"] * 4
    want = sum(x.nbytes for x in (g.node_labels, g.src, g.dst, g.elabel))
    (up,) = tracer.find("build.upload")
    assert up["attrs"]["bytes"] == want
    (ev,) = tracer.find_events("build.copy")
    assert ev["attrs"] == {"what": "upload", "to": "device", "bytes": want}


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_upload_span_carries_the_ring(dev):
    """The ``build.upload`` span names the pinned ring's shape and the
    chunks staged through it: none on ``cpu`` and ``meta``, where the
    copy event keeps its attributes."""
    from repro_torch.core import staging
    g = _graph()
    with obs.tracing() as tracer:
        partition._upload(g, torch.device(dev))
    (up,) = tracer.find("build.upload")
    want = (0 if dev == "cpu" else
            sum(x.nbytes for x in (g.node_labels, g.src, g.dst, g.elabel)))
    assert up["attrs"] == {"bytes": want, "staged_chunks": 0,
                           "slots": staging.SLOTS,
                           "slot_bytes": staging.SLOT_BYTES}
    (ev,) = tracer.find_events("build.copy")
    assert ev["attrs"] == {"what": "upload", "to": "device", "bytes": want}


def test_no_tracer_no_span_and_no_profiler_range():
    assert obs.current_tracer() is None
    assert obs.span("build.bisim") is obs.NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_bisim(_graph(), 4, device="cpu")
    assert not [e for e in prof.events() if e.name.startswith("build.")]


def test_spans_without_a_profiler_open_no_range():
    from repro_torch.obs import ranges
    assert ranges.profiler_range("build.bisim") is None
    _, tracer, _ = _traced(_graph(), profiled=False)
    assert {s["name"] for s in tracer.spans} == CHILDREN - {
        "build.stores"} | {"build.bisim"}


def test_a_failing_span_closes_its_profiler_range():
    with obs.tracing() as tracer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with pytest.raises(KeyError):
                with obs.span("build.bisim"):
                    with obs.span("build.prepare"):
                        raise KeyError("x")
            with obs.span("build.fetch"):
                pass
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith("build.")}
    assert set(ranges) == {"build.bisim", "build.prepare", "build.fetch"}
    assert ranges["build.fetch"].cpu_parent is None
    assert [s["attrs"].get("error") for s in tracer.spans] == [
        "KeyError", "KeyError", None]


@pytest.mark.parametrize("with_store", [False, True])
def test_tracing_changes_no_output(with_store):
    g = _graph()
    plain = build_bisim(g, 6, device="cpu", with_store=with_store)
    traced, _, _ = _traced(g, with_store=with_store)
    assert np.array_equal(plain.pids, traced.pids)
    assert plain.pids.dtype == traced.pids.dtype
    assert plain.counts == traced.counts
    assert plain.converged_at == traced.converged_at
    fields = ("iteration", "num_partitions", "bytes_sorted", "bytes_scanned")
    assert [[getattr(s, f) for f in fields] for s in plain.stats] == [
        [getattr(s, f) for f in fields] for s in traced.stats]
    if with_store:
        for a, b in zip(plain.stores, traced.stores):
            assert np.array_equal(a.keys, b.keys)
            assert np.array_equal(a.pids, b.pids)
        assert plain.next_pid == traced.next_pid


def test_report_shows_each_levels_device_time():
    tracer = obs.Tracer()
    for level, ms in ((0, 1.5), (1, 2.25)):
        with tracer.span("build.iteration", level=level) as sp:
            pass
        sp.set(device_ms=ms, trimmed=False)
    rep = obs.MetricsReport.from_tracer(tracer)
    assert rep.levels[0]["build.iteration.device"] == pytest.approx(1.5e-3)
    assert rep.levels[1]["build.iteration.device"] == pytest.approx(2.25e-3)
    assert "build.iteration.device=0.002s" in rep.format()


def test_launcher_prints_each_levels_device_ms(capsys):
    g = _graph()
    args = launcher.build_parser().parse_args(
        ["--device", "cpu", "--k", "2"])
    res = build_bisim(g, 2, device="cpu")
    with obs.tracing() as tracer:
        for j, ms in enumerate((0.5, 12.3, 7.0)):
            tracer.event("build.level", level=j, device_ms=ms,
                         trimmed=False)
        launcher.report(args, res, 0.1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("  iter")]
    assert len(lines) == len(res.stats) == 3
    assert [ln.split("  device=")[1] for ln in lines] == [
        "0.5 ms", "12.3 ms", "7.0 ms"]
    launcher.report(args, res, 0.1)  # no tracer: the lines as before
    assert "device=" not in capsys.readouterr().out


@pytest.mark.gpu
def test_level_device_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA events time the levels")
    g = gen.powerlaw_graph(200_000, 2_000_000, 3, 2, seed=5)
    build_bisim(g, 4, device="cuda")  # warm-up: the fold's build
    torch.cuda.synchronize()
    with obs.tracing() as tracer:
        t0 = time.perf_counter()
        res = build_bisim(g, 4, device="cuda", early_stop=False)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    levels = tracer.find_events("build.level")
    assert [e["attrs"]["level"] for e in levels] == list(range(5))
    assert all(e["attrs"]["device_ms"] > 0 for e in levels)
    assert not any(e["attrs"]["trimmed"] for e in levels)
    assert sum(e["attrs"]["device_ms"] for e in levels) < wall_ms
    spans = tracer.find("build.iteration")
    assert [s["attrs"]["device_ms"] for s in spans] == [
        e["attrs"]["device_ms"] for e in levels]
    (up,) = tracer.find("build.upload")
    assert up["attrs"]["bytes"] == sum(
        x.nbytes for x in (g.node_labels, g.src, g.dst, g.elabel))
    (fetch,) = tracer.find("build.fetch")
    assert fetch["attrs"]["bytes"] == res.pids.nbytes
