"""The port's maintenance (`repro_torch.core.maintenance`, Algorithms
2-4 in memory) against the JAX package's `BisimMaintainer`, on the CPU.

The same update streams (`tests/test_update_fuzz.py`'s generators, ops
and op drawer, imported unchanged) and the cases of
`tests/test_maintenance.py` run through the reference and through the
port, the port both with its device propagation (``device="cpu"``: the
folds take the kernel's plain version) and on its numpy host path.
Everything maintenance outputs is integers, so after every op the bar is
equality: pid histories, ``next_pid``, `MaintenanceReport.as_dict()`
without ``level_seconds``, tombstones and the extracted stores; the
reference's oracle check must hold for the port as well.
"""
import re
import warnings

import numpy as np
import pytest

from repro.core import BisimMaintainer as RefMaintainer
from repro.core import InMemoryBackend as RefBackend
from repro.graph import generators as rgen
from repro.graph.storage import paper_example_graph as ref_paper_graph
from repro.launch import bisim as ref_launcher
from test_update_fuzz import GENERATORS, OPS, _apply_op, _oracle_check

torch = pytest.importorskip("torch")
from repro_torch.core import (BisimMaintainer, InMemoryBackend,  # noqa: E402
                              MaintenanceBackend, faults)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.storage import paper_example_graph  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]
ROUTES = ["device", "host"]
# the port's twins of test_update_fuzz.GENERATORS (same sizes and seeds)
PORT_GENERATORS = {
    "random": lambda: gen.random_graph(40, 110, 3, 2, seed=2),
    "powerlaw": lambda: gen.powerlaw_graph(36, 100, 2, 2, seed=3),
    "structured": lambda: gen.structured_graph(10, seed=5),
}


def _port(graph, k, route, store="mirror", **kw):
    """The port's maintainer on the CPU: device propagation with the
    stores on the device ('mirror') or on the host ('host-store'), or the
    numpy host path."""
    if route == "host":
        return BisimMaintainer(graph, k, device="cpu",
                               device_propagation=False, **kw)
    backend = InMemoryBackend(graph, device="cpu")
    backend.enable_device(store_on_device=(store == "mirror"))
    return BisimMaintainer(backend, k, **kw)


def _ref_device(graph, k, store, **kw):
    backend = RefBackend(graph)
    backend.enable_device(store_on_device=(store == "mirror"))
    return RefMaintainer(backend, k, device=True, **kw)


def _record(m) -> list:
    """Collect every `MaintenanceReport` the maintainer's propagation
    returns (add_edges, delete_edges and delete_node go through it)."""
    reports = []
    inner = m._propagate

    def propagate(frontier0):
        rep = inner(frontier0)
        reports.append(rep)
        return rep
    m._propagate = propagate
    return reports


def _no_seconds(rep) -> dict:
    d = rep.as_dict()
    del d["level_seconds"]
    return d


def _assert_same(mine, ref, ctx, reports=None, *, stores=False):
    assert mine.k == ref.k, ctx
    for j in range(ref.k + 1):
        np.testing.assert_array_equal(np.asarray(mine.pids[j]),
                                      np.asarray(ref.pids[j]),
                                      err_msg=f"{ctx} level={j}")
    assert list(mine.next_pid) == list(ref.next_pid), ctx
    np.testing.assert_array_equal(mine._tombstone, ref._tombstone,
                                  err_msg=str(ctx))
    if reports is not None:
        # ``device`` says which path ran, so it is held to the route
        assert all(r.device == mine.device_propagation for r in reports[0])
        assert [{**_no_seconds(r), "device": None} for r in reports[0]] == \
            [{**_no_seconds(r), "device": None} for r in reports[1]], ctx
    if stores:
        for j in range(ref.k + 1):
            assert mine.stores[j].to_dict() == ref.stores[j].to_dict(), \
                (ctx, j)


def _lockstep(mines, ref, seed, ctx, steps=5):
    """Drive one seeded stream through the reference and every port
    maintainer, comparing after every op."""
    reps = [_record(m) for m in mines]
    ref_reps = _record(ref)
    rngs = [np.random.default_rng(seed) for _ in mines]
    rng = np.random.default_rng(seed)
    for step in range(steps):
        op = OPS[int(rng.integers(0, len(OPS)))]
        _apply_op(ref, op, rng)
        for m, r, mine_reps in zip(mines, rngs, reps):
            assert OPS[int(r.integers(0, len(OPS)))] == op
            _apply_op(m, op, r)
            _assert_same(m, ref, (*ctx, step, op), (mine_reps, ref_reps))
    for m in mines:
        _assert_same(m, ref, ctx, stores=True)
        _oracle_check(m, ctx)


# ----------------------------------------------------- the fuzz streams
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_fuzz_inmemory_matches_reference(gname, mode):
    """test_update_fuzz's in-memory stream (seed 101): the port, on the
    device path and on the host path, against the reference's host."""
    mines = [_port(PORT_GENERATORS[gname](), 3, route, mode=mode)
             for route in ROUTES]
    _lockstep(mines, RefMaintainer(GENERATORS[gname](), 3, mode=mode),
              101, (gname, mode))


@pytest.mark.parametrize("store", ["mirror", "host-store"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_fuzz_device_parity_matches_reference(gname, mode, store):
    """test_update_fuzz's host-vs-device stream (seed 303): the port's
    device path in both store placements against the reference's device
    path in the same placement."""
    mine = _port(PORT_GENERATORS[gname](), 3, "device", store, mode=mode)
    assert mine.device_propagation and mine.device == torch.device("cpu")
    _lockstep([mine], _ref_device(GENERATORS[gname](), 3, store, mode=mode),
              303, (gname, mode, store))
    assert tfold.sig_fold.launches == 0  # the CPU takes the plain route


@pytest.mark.parametrize("route", ROUTES)
def test_apply_ops_matches_reference(route):
    ops = [("add_edges", dict(src=np.array([0, 3]), elabel=np.array([1, 0]),
                              dst=np.array([9, 4]))),
           ("add_nodes", dict(labels=np.array([2, 2]))),
           ("delete_node", dict(nid=np.array([5]))),
           ("delete_edges", dict(src=np.array([1]), elabel=np.array([0]),
                                 dst=np.array([2]))),
           ("add_edges", dict(src=np.array([99]), elabel=np.array([0]),
                              dst=np.array([1]))),  # rejected: no node 99
           ("compact", {}), ("change_k", dict(new_k=np.array([4])))]
    mine = _port(gen.random_graph(30, 90, 3, 2, seed=17), 3, route)
    ref = RefMaintainer(rgen.random_graph(30, 90, 3, 2, seed=17), 3)
    got, rej = mine.apply_ops(ops, logged=False)
    want, rej_ref = ref.apply_ops(ops, logged=False)
    assert rej == rej_ref == 1
    assert _no_seconds(got) == {**_no_seconds(want),
                                "device": route == "device"}
    assert mine.last_changed is None and ref.last_changed is None
    _assert_same(mine, ref, route, stores=True)


# ------------------------------------- the cases of test_maintenance.py
def _paper_no_propagation(m):
    new = m.add_node(1)
    return m.add_edge(1, 0, new)


def _paper_with_propagation(m):
    return m.add_edge(5, 0, 4)


def _add_isolated_nodes(m):
    return m.add_nodes([0, 1, 2, 7, 7])


def _delete_node(m):
    return m.delete_node(7)


def _compact(m):
    for nid in (4, 17, 29):
        m.delete_node(nid)
    remap = m.compact()
    m.add_edge(0, 0, 26)
    m.add_nodes([1, 2])
    return remap


def _compact_noop_and_reanimation(m):
    remap = m.compact()
    m.delete_node(5)
    m.add_edge(5, 0, 6)
    return np.concatenate([remap, m.compact()])


def _rejected_insert(m):
    m.delete_node(19)
    with pytest.raises(ValueError):
        m.add_edge(-1, 0, 3)
    for bad in (-1, 20):
        with pytest.raises(ValueError):
            m.delete_node(bad)
    return m.compact()


def _rebuild(m):
    n = m.graph.num_nodes
    m.add_edges([0], [1], [5])
    return m.add_edges(list(range(n)), [1] * n,
                       [(i + 1) % n for i in range(n)])


def _report_levels(m):
    return m.add_edge(0, 0, 1)


def _compact_then_stream(m):
    for nid in (2, 11, 23):
        m.delete_node(nid)
    m.compact()
    m.add_edges([0, 3], [1, 0], [9, 4])
    m.delete_edges(m.graph.src[:2], m.graph.elabel[:2], m.graph.dst[:2])
    m.add_nodes([2, 2])
    m.delete_node(5)
    m.compact()
    m.add_edge(0, 0, 1)
    m.change_k(4)


def _change_k(m):
    m.change_k(5)
    m.change_k(2)
    return m.add_edge(0, 0, 1)


def _multiset(m):
    m.add_edge(0, 0, 1)
    m.add_edges([2, 2, 5], [1, 0, 1], [9, 9, 3])
    m.add_nodes([0, 2])
    m.delete_node(7)
    m.compact()


# name: (scenario, graph factory name, its arguments, k, maintainer kw)
CASES = {
    "paper_no_propagation": (_paper_no_propagation, "paper", (), 2, {}),
    "paper_with_propagation": (_paper_with_propagation, "paper", (), 2, {}),
    "add_isolated_nodes": (_add_isolated_nodes, "random_graph",
                           (40, 100, 3, 2, 0), 4, {}),
    "delete_node": (_delete_node, "random_graph", (25, 60, 2, 2, 5), 3, {}),
    "compact": (_compact, "random_graph", (30, 90, 3, 2, 11), 3, {}),
    "compact_noop_reanimation": (_compact_noop_and_reanimation,
                                 "random_graph", (20, 50, 2, 2, 3), 2, {}),
    "rejected_updates": (_rejected_insert, "random_graph",
                         (20, 50, 2, 2, 3), 2, {}),
    "rebuild_heuristic": (_rebuild, "complete_graph", (12,), 4,
                          dict(rebuild_threshold=0.5)),
    "report_levels": (_report_levels, "random_graph", (30, 80, 3, 2, 1), 3,
                      {}),
    "compact_then_stream": (_compact_then_stream, "random_graph",
                            (30, 90, 3, 2, 17), 3, {}),
    "change_k": (_change_k, "random_graph", (40, 120, 3, 2, 2), 3, {}),
    "multiset": (_multiset, "random_graph", (30, 90, 3, 2, 13), 3,
                 dict(mode="multiset")),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_maintenance_case_matches_reference(case, route):
    scenario, gname, args, k, kw = CASES[case]
    if gname == "paper":
        graphs = paper_example_graph(), ref_paper_graph()
    else:
        graphs = getattr(gen, gname)(*args), getattr(rgen, gname)(*args)
    mine = _port(graphs[0], k, route, **kw)
    ref = RefMaintainer(graphs[1], k, **kw)
    reps = _record(mine), _record(ref)
    out_mine, out_ref = scenario(mine), scenario(ref)
    if isinstance(out_ref, np.ndarray):
        np.testing.assert_array_equal(out_mine, out_ref)
    elif hasattr(out_ref, "as_dict"):
        assert _no_seconds(out_mine) == {**_no_seconds(out_ref),
                                         "device": route == "device"}
        assert len(out_mine.level_seconds) == mine.k
    else:
        assert out_mine == out_ref  # add_nodes' new ids, or None
    assert mine.num_tombstones == ref.num_tombstones
    np.testing.assert_array_equal(mine.graph.src, ref.graph.src)
    np.testing.assert_array_equal(mine.graph.dst, ref.graph.dst)
    np.testing.assert_array_equal(mine.graph.elabel, ref.graph.elabel)
    np.testing.assert_array_equal(mine.graph.node_labels,
                                  ref.graph.node_labels)
    assert [_no_seconds(r)["rebuilt"] for r in reps[0]] == \
        [_no_seconds(r)["rebuilt"] for r in reps[1]]
    _assert_same(mine, ref, case, stores=True)
    _oracle_check(mine, (case, route))


def test_maintenance_rejects_unknown_mode():
    with pytest.raises(ValueError):
        BisimMaintainer(paper_example_graph(), 2, mode="bogus",
                        device="cpu")


# ------------------------------------------------------- no fallback
class _BrokenResident(InMemoryBackend):
    """A backend whose fused device step fails."""

    def propagate_levels_resident(self, frontier, *, dedup=True):
        raise RuntimeError("device step failed")


def test_device_failure_raises_without_fallback():
    m = BisimMaintainer(_BrokenResident(gen.random_graph(30, 80, 3, 2, 1),
                                        device="cpu"), 3)
    before = [p.copy() for p in m.pids]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a RuntimeWarning would fail here
        with pytest.raises(RuntimeError, match="device step failed"):
            m.add_edge(0, 0, 1)
    assert m.device_propagation
    for a, b in zip(before, m.pids):
        np.testing.assert_array_equal(a, b)  # no host path ran instead


def test_injected_device_fault_raises():
    """A transient fault at the device fault point propagates: nothing
    retries it on the host."""
    m = _port(gen.random_graph(30, 80, 3, 2, 1), 3, "device")
    plan = faults.FaultPlan(transient_at=[1], kinds={"device"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with faults.install_fault_plan(plan):
            with pytest.raises(faults.TransientIOError):
                m.add_edge(0, 0, 1)
    assert m.device_propagation


class _HostOnly(MaintenanceBackend):
    """A backend without the device capability (only what the
    constructor touches before it asks)."""

    def __init__(self, graph):
        self.graph = graph
        self.device = torch.device("cpu")

    num_nodes = property(lambda self: self.graph.num_nodes)
    num_edges = property(lambda self: self.graph.num_edges)

    def build(self, k, mode, *, result=None):
        self.built = k

    pid_column = pid_at = set_pid_at = append_pid_rows = resolve = None
    frontier_signatures = parents_of = incident_edges = None
    add_node_rows = add_edge_rows = remove_edge_rows = compact = None
    truncate_k = extend_k = None


def test_device_propagation_needs_the_capability():
    g = gen.random_graph(10, 20, 2, 2, 1)
    with pytest.raises(ValueError, match="device_propagation=False"):
        BisimMaintainer(_HostOnly(g), 2)
    assert not BisimMaintainer(_HostOnly(g), 2,
                               device_propagation=False).device_propagation
    with pytest.raises(ValueError, match="differs"):
        BisimMaintainer(InMemoryBackend(g, device="cpu"), 2, device="cuda")


def test_maintainer_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BisimMaintainer(paper_example_graph(), 2)


# ---------------------------------------------------- graph mutations
@pytest.mark.parametrize("seed", range(4))
def test_graph_mutations_match_reference(seed):
    """The port's vectorised canonical sort, merge insert, removal and
    E_tts order give the reference Graph's arrays, on canonical graphs,
    negative labels and a non-canonical graph."""
    from repro.graph.storage import Graph as RefGraph
    from repro_torch.graph.storage import Graph
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 30))
        e = int(rng.integers(0, 80))
        lab = rng.integers(0, 3, n)
        cols = (rng.integers(0, n, e), rng.integers(0, n, e),
                rng.integers(-2 * (seed % 2), 4, e))
        extra = tuple(rng.integers(0, n, 4) for _ in range(2)) + (
            rng.integers(0, 5, 4),)
        for build in ("from_edges", "raw"):
            if build == "raw":
                g, rg = Graph(lab, *cols), RefGraph(lab, *cols)
            else:
                g, rg = Graph.from_edges(lab, *cols), \
                    RefGraph.from_edges(lab, *cols)
            pairs = [(g, rg), (g.with_edges_added(*extra),
                               rg.with_edges_added(*extra))]
            if pairs[1][0].num_edges:
                a, b = pairs[1]
                take = rng.integers(0, a.num_edges, 3)
                pairs.append((a.with_edges_removed(a.src[take], a.dst[take],
                                                   a.elabel[take]),
                              b.with_edges_removed(b.src[take], b.dst[take],
                                                   b.elabel[take])))
            for mine, ref in pairs:
                for col in ("src", "dst", "elabel"):
                    np.testing.assert_array_equal(getattr(mine, col),
                                                  getattr(ref, col))
                    assert getattr(mine, col).dtype == np.int32
                np.testing.assert_array_equal(mine.in_order(),
                                              ref.in_order())
    with pytest.raises(ValueError, match="out of range"):
        Graph.from_edges(np.zeros(3), [0], [1], [0]).with_edges_added(
            [3], [0], [0])


# ------------------------------------------------------------ launcher
_TIMES = re.compile(r"\d+\.\d+(?=s|ms| ms)|_ms=\d+\.\d+")


def _lines(text: str) -> list:
    """Launcher output with its wall times blanked."""
    return [_TIMES.sub("T", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("argv", [
    ["add-edges", "--count", "6"],
    ["add-edges", "--edge", "1:0:2", "--edge", "3:1:4"],
    ["delete-node", "--nid", "7"],
    ["compact", "--delete-nodes", "3,7,11"],
])
@pytest.mark.parametrize("route", ROUTES)
def test_launcher_subcommands_match_reference(capsys, argv, route):
    common = ["--generator", "random", "--nodes", "300", "--edges", "900",
              "--k", "4", "--seed", "3"]
    path = ["--device-maintenance"] if route == "device" else []
    ref_launcher._dispatch(ref_launcher.build_parser().parse_args(
        common + path + argv))
    want = capsys.readouterr().out
    mine_path = [] if route == "device" else ["--host-maintenance"]
    launcher.main(["--device", "cpu"] + common + mine_path + argv)
    got = capsys.readouterr().out
    assert f"propagation={route}" in got
    assert _lines(got) == _lines(want)


def test_launcher_subcommand_refuses_oocore():
    """Out-of-core maintenance runs (tests/test_torch_ooc_maintenance.py);
    what the launcher still refuses, before building anything, is an
    out-of-core write-ahead log without a workdir to keep it in."""
    with pytest.raises(SystemExit, match="--wal needs --oocore and "
                                         "--workdir"):
        launcher.main(["--device", "cpu", "--generator", "random",
                       "--nodes", "50", "--edges", "100", "--oocore",
                       "--wal", "add-edges"])
