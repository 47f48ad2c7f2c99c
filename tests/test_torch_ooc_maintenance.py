"""The port's out-of-core maintenance (`repro_torch.exmem.OocBackend` under
`repro_torch.core.BisimMaintainer`) against the JAX package's, on the CPU.

The streams and cases are those of `tests/test_ooc_maintenance.py` and the
out-of-core streams of `tests/test_update_fuzz.py` (its generators, ops and
op drawer, imported unchanged).  Each runs through the reference's
`OocBackend` and through the port's, the port both with device
propagation (``device="cpu"``: the frontier and chunk folds take the
kernels' plain versions) and on its numpy host path.  Everything the
backend keeps is integers, so after every op the bar is equality: pid
files, ``next_pid``, tombstones, the `IOStats` dicts (the paper's cost
model, charge for charge), the stores' contents and the compact remaps;
at the end each store's run state after ``flush()``.  Then the
launcher's ``--oocore`` maintenance, ``--wal`` and ``recover`` lines,
and the no-fallback rule.
"""
import re
import warnings

import numpy as np
import pytest

from repro.core import BisimMaintainer as RefMaintainer
from repro.exmem import OocBackend as RefOocBackend
from repro.graph import generators as rgen
from repro.launch import bisim as ref_launcher
from test_ooc_maintenance import GENERATORS as OOC_GENERATORS
from test_update_fuzz import GENERATORS, OPS, _apply_op, _oracle_check

torch = pytest.importorskip("torch")
from repro_torch.core import BisimMaintainer  # noqa: E402
from repro_torch.exmem import OocBackend  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]
ROUTES = ["device", "host"]
# the port's twins of the reference tests' generators (same sizes, seeds)
PORT_OOC_GENERATORS = {
    "random": lambda: gen.random_graph(70, 260, 3, 2, seed=2),
    "powerlaw": lambda: gen.powerlaw_graph(60, 220, 2, 2, seed=3),
    "dag": lambda: gen.random_dag(60, 200, 3, 2, seed=4),
    "structured": lambda: gen.structured_graph(18, seed=5),
}
PORT_FUZZ_GENERATORS = {
    "random": lambda: gen.random_graph(40, 110, 3, 2, seed=2),
    "powerlaw": lambda: gen.powerlaw_graph(36, 100, 2, 2, seed=3),
    "structured": lambda: gen.structured_graph(10, seed=5),
}


def _port(graph, k, route, workdir, *, backend_kw=None, **kw):
    """The port's out-of-core maintainer on the CPU, on ``route``."""
    backend = OocBackend(graph, workdir=str(workdir), device="cpu",
                         **(backend_kw or {}))
    return BisimMaintainer(backend, k,
                           device_propagation=route == "device", **kw)


def _ref(graph, k, workdir, *, backend_kw=None, **kw):
    return RefMaintainer(RefOocBackend(graph, workdir=str(workdir),
                                       **(backend_kw or {})), k, **kw)


def _pids(m) -> list:
    """The pid files as they lie on disk (`pid_column` would charge a
    scan to the backend's IOStats)."""
    return [np.load(p) for p in m.backend.pid_paths]


def _assert_same(mine, ref, ctx, *, stores=True):
    """Pid files, next_pid, tombstones, IOStats and stores, exactly."""
    assert mine.k == ref.k, ctx
    assert len(mine.backend.pid_paths) == mine.k + 1
    for j, (a, b) in enumerate(zip(_pids(mine), _pids(ref))):
        assert a.dtype == b.dtype, (ctx, j)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} level={j}")
    assert list(mine.next_pid) == list(ref.next_pid), ctx
    np.testing.assert_array_equal(mine._tombstone, ref._tombstone,
                                  err_msg=str(ctx))
    assert mine.backend.io.to_dict() == ref.backend.io.to_dict(), ctx
    assert mine.backend.num_nodes == ref.backend.num_nodes, ctx
    assert mine.backend.num_edges == ref.backend.num_edges, ctx
    if stores:
        for j in range(ref.k + 1):
            assert mine.stores[j].to_dict() == ref.stores[j].to_dict(), \
                (ctx, j)


def _assert_store_states(mines, ref, ctx):
    """Each level's store flushed, then its run state (run files relative
    to the spill dir, lengths, checksums) equal to the reference's."""
    for j, s in enumerate(ref.stores):
        s.flush()
        want = s.state()
        for m in mines:
            m.stores[j].flush()
            assert m.stores[j].state() == want, (ctx, j)
    for m in mines:
        assert m.backend.io.to_dict() == ref.backend.io.to_dict(), ctx


def _close(*ms):
    for m in ms:
        m.backend.close()


# ------------------------------------------------- the backend streams
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(OOC_GENERATORS))
def test_ooc_stream_matches_reference(tmp_path, gname, mode):
    """test_ooc_maintenance's stream (add_edges, delete_edges, add_nodes,
    delete_node, compact) through the port on both routes and the
    reference, equal after every op; the compact remaps equal too."""
    k = 3
    kw = dict(backend_kw=dict(chunk_edges=48, chunk_nodes=32,
                              spill_threshold=32), mode=mode)
    mines = [_port(PORT_OOC_GENERATORS[gname](), k, route,
                   tmp_path / route, **kw) for route in ROUTES]
    ref = _ref(OOC_GENERATORS[gname](), k, tmp_path / "ref", **kw)
    assert mines[0].backend.ooc.num_edge_chunks >= 4
    g = OOC_GENERATORS[gname]()
    rng = np.random.default_rng(11)
    n = g.num_nodes
    e = rng.integers(0, n, (4, 2))
    lab = rng.integers(0, 2, 4)
    i = rng.integers(0, g.num_edges, 3)
    victim = int(rng.integers(0, n))
    steps = [
        ("add_edges", lambda m: m.add_edges(e[:, 0], lab, e[:, 1])),
        ("delete_edges",
         lambda m: m.delete_edges(g.src[i], g.elabel[i], g.dst[i])),
        ("add_nodes", lambda m: m.add_nodes([0, 1, 1])),
        ("delete_node", lambda m: m.delete_node(victim)),
        ("compact", lambda m: m.compact()),
    ]
    for name, step in steps:
        want = step(ref)
        for m in mines:
            got = step(m)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want)
            elif isinstance(want, list):
                assert got == want
            _assert_same(m, ref, (gname, mode, name))
    _assert_store_states(mines, ref, (gname, mode))
    for m in mines:
        _oracle_check(m, (gname, mode))
    assert tfold.sig_fold.launches == 0  # the CPU takes the plain route
    assert tfold.chunk_sig_fold.launches == 0
    _close(ref, *mines)


@pytest.mark.parametrize("seed", [202, 404])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_ooc_fuzz_stream_matches_reference(tmp_path, gname, mode, seed):
    """test_update_fuzz's out-of-core streams (the oracle stream, seed
    202, and the device-parity stream, seed 404): k=2, every op kind,
    change_k across levels, equal after every op and the oracle's
    partition at the end."""
    kw = dict(backend_kw=dict(chunk_edges=32, chunk_nodes=24,
                              spill_threshold=16), mode=mode)
    mines = [_port(PORT_FUZZ_GENERATORS[gname](), 2, route,
                   tmp_path / route, **kw) for route in ROUTES]
    ref = _ref(GENERATORS[gname](), 2, tmp_path / "ref", **kw)
    rng = np.random.default_rng(seed)
    rngs = [np.random.default_rng(seed) for _ in mines]
    for step in range(5):
        op = OPS[int(rng.integers(0, len(OPS)))]
        _apply_op(ref, op, rng)
        for m, r in zip(mines, rngs):
            assert OPS[int(r.integers(0, len(OPS)))] == op
            _apply_op(m, op, r)
            _assert_same(m, ref, (gname, mode, seed, step, op))
    _assert_store_states(mines, ref, (gname, mode, seed))
    for m in mines:
        _oracle_check(m, (gname, mode, seed))
    _close(ref, *mines)


# ------------------------------------------ the cases of the reference
def _rebuild(m):
    n = m.backend.num_nodes
    return m.add_edges(list(range(n)), [1] * n,
                       [(i + 1) % n for i in range(n)])


def _rejected_insert(m):
    m.delete_node(19)
    with pytest.raises(ValueError):
        m.add_edge(-1, 0, 3)
    assert m.num_tombstones == 1
    return m.compact()


def _change_k_spills(m):
    assert any(s.num_spilled_runs > 0 for s in m.backend.stores)
    rng = np.random.default_rng(3)
    for new_k in (5, 2, 4, 1):  # increase and decrease, repeatedly
        m.change_k(new_k)
        assert len(m.backend.pid_paths) == len(m.backend.stores) == new_k + 1
        n = m.backend.num_nodes
        m.add_edge(int(rng.integers(0, n)), 1, int(rng.integers(0, n)))


def _compact_then_updates(m):
    for nid in (3, 9, 27):
        m.delete_node(nid)
    m.compact()
    m.add_edges([0, 5], [1, 0], [10, 2])
    g = m.graph
    m.delete_edges(g.src[:2], g.elabel[:2], g.dst[:2])
    m.add_nodes([1, 2])
    m.delete_node(7)
    remap = m.compact()
    m.change_k(2)
    m.add_edge(1, 0, 4)
    return remap


def _change_k(m):
    m.change_k(2)
    m.change_k(4)  # out of core an increase rebuilds
    return m.add_edge(0, 0, 1)


# name: (scenario, generator, its arguments, k, backend kw, maintainer kw)
CASES = {
    "rebuild_heuristic": (_rebuild, "complete_graph", (10,), 3,
                          dict(chunk_edges=24),
                          dict(rebuild_threshold=0.4)),
    "rejected_insert": (_rejected_insert, "random_graph",
                        (20, 50, 2, 2, 3), 2, dict(chunk_edges=16), {}),
    "change_k_spills": (_change_k_spills, "random_graph",
                        (60, 220, 3, 2, 21), 3,
                        dict(chunk_edges=48, chunk_nodes=32,
                             spill_threshold=8), {}),
    "compact_then_updates": (_compact_then_updates, "random_graph",
                             (50, 160, 3, 2, 22), 3,
                             dict(chunk_edges=48, chunk_nodes=32,
                                  spill_threshold=16), {}),
    "change_k": (_change_k, "random_graph", (40, 150, 3, 2, 7), 3,
                 dict(chunk_edges=32), {}),
}


def _no_seconds(rep) -> dict:
    d = rep.as_dict()
    del d["level_seconds"], d["device"]
    return d


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ooc_case_matches_reference(tmp_path, case, route):
    scenario, gname, args, k, bkw, kw = CASES[case]
    mine = _port(getattr(gen, gname)(*args), k, route, tmp_path / "mine",
                 backend_kw=bkw, **kw)
    ref = _ref(getattr(rgen, gname)(*args), k, tmp_path / "ref",
               backend_kw=bkw, **kw)
    _assert_same(mine, ref, (case, "build"))
    out_mine, out_ref = scenario(mine), scenario(ref)
    if isinstance(out_ref, np.ndarray):
        np.testing.assert_array_equal(out_mine, out_ref)
    elif out_ref is not None:
        assert _no_seconds(out_mine) == _no_seconds(out_ref)
        assert out_mine.device == (route == "device")
    if case == "rebuild_heuristic":
        assert out_mine.rebuilt
    _assert_same(mine, ref, case)
    _assert_store_states([mine], ref, case)
    _oracle_check(mine, (case, route))
    _close(mine, ref)


@pytest.mark.parametrize("route", ROUTES)
def test_ooc_counters_linear_in_k_match_reference(tmp_path, route):
    """§4's per-update bound: for a fixed no-op update (an existing edge
    again) the IOStats deltas grow exactly linearly in k, and each equals
    the reference's."""
    g, rg = gen.random_graph(80, 300, 3, 2, seed=9), \
        rgen.random_graph(80, 300, 3, 2, seed=9)
    deltas = {}
    for kk in (2, 4, 8):
        kw = dict(backend_kw=dict(chunk_edges=64, chunk_nodes=32))
        mine = _port(g, kk, route, tmp_path / f"m{kk}", **kw)
        ref = _ref(rg, kk, tmp_path / f"r{kk}", **kw)
        before = mine.backend.io.to_dict()
        rep = mine.add_edge(int(g.src[0]), int(g.elabel[0]), int(g.dst[0]))
        ref.add_edge(int(g.src[0]), int(g.elabel[0]), int(g.dst[0]))
        assert sum(rep.nodes_changed) == 0
        _assert_same(mine, ref, (route, kk))
        after = mine.backend.io.to_dict()
        deltas[kk] = (after["sort_cost"] - before["sort_cost"],
                      after["scan_cost"] - before["scan_cost"])
        _close(mine, ref)
    for i in range(2):
        d1 = deltas[4][i] - deltas[2][i]
        assert d1 > 0 and deltas[8][i] - deltas[4][i] == 2 * d1


def test_apply_ops_logged_false_matches_reference(tmp_path):
    """apply_ops with records the caller already logged: nothing is
    appended, the rejected op is skipped and counted, as the reference
    does."""
    ops = [("add_edges", dict(src=np.array([0, 3]), elabel=np.array([1, 0]),
                              dst=np.array([9, 4]))),
           ("add_nodes", dict(labels=np.array([2, 2]))),
           ("delete_node", dict(nid=np.array([5]))),
           ("add_edges", dict(src=np.array([99]), elabel=np.array([0]),
                              dst=np.array([1]))),  # rejected: no node 99
           ("compact", {}), ("change_k", dict(new_k=np.array([3])))]
    kw = dict(backend_kw=dict(chunk_edges=32, wal=True, io_threads=0),
              wal=True)
    mine = _port(gen.random_graph(30, 90, 3, 2, seed=17), 2, "device",
                 tmp_path / "mine", **kw)
    ref = _ref(rgen.random_graph(30, 90, 3, 2, seed=17), 2,
               tmp_path / "ref", **kw)
    got, rej = mine.apply_ops(ops, logged=False)
    want, rej_ref = ref.apply_ops(ops, logged=False)
    assert rej == rej_ref == 1
    assert _no_seconds(got) == _no_seconds(want)
    assert mine.backend._wal.last_lsn == ref.backend._wal.last_lsn == 0
    _assert_same(mine, ref, "apply_ops")
    mine.apply_ops(ops[:2])  # logged: one record an op
    assert mine.backend._wal.last_lsn == 2
    _close(mine, ref)


def test_result_matches_reference(tmp_path):
    mine = _port(gen.random_graph(30, 90, 3, 2, seed=1), 3, "device",
                 tmp_path / "mine", backend_kw=dict(chunk_edges=32))
    ref = _ref(rgen.random_graph(30, 90, 3, 2, seed=1), 3, tmp_path / "ref",
               backend_kw=dict(chunk_edges=32))
    mine.add_edge(0, 1, 2)
    ref.add_edge(0, 1, 2)
    a, b = mine.result(), ref.result()
    np.testing.assert_array_equal(a.pids, b.pids)
    assert a.counts == b.counts and a.k_requested == b.k_requested
    _close(mine, ref)


# ------------------------------------------------------- no fallback
def test_ooc_device_failure_raises_without_fallback(tmp_path):
    """The reference degrades a failed device step to the host path
    (tests/test_durability.py::test_device_failure_falls_back_to_host);
    the port raises, and keeps asking for the device."""
    be = OocBackend(gen.random_graph(60, 170, 3, 2, seed=7), chunk_edges=32,
                    chunk_nodes=24, workdir=str(tmp_path / "m"),
                    io_threads=0, device="cpu")
    m = BisimMaintainer(be, 2)
    before = _pids(m)

    def dead_device(*a, **k):
        raise RuntimeError("device lost")

    be.propagate_level_device = dead_device
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a RuntimeWarning would fail here
        with pytest.raises(RuntimeError, match="device lost"):
            m.add_edges(np.array([0, 1], np.int32),
                        np.array([0, 1], np.int32),
                        np.array([2, 3], np.int32))
    assert m.device_propagation
    for a, b in zip(before, _pids(m)):
        np.testing.assert_array_equal(a, b)  # no host level ran instead
    be.close()


def test_ooc_backend_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OocBackend(gen.random_graph(10, 20, 2, 2, seed=1),
                   workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        OocBackend.restore(str(tmp_path))


def test_wal_needs_a_durable_backend():
    with pytest.raises(ValueError, match="write-ahead log"):
        BisimMaintainer(gen.random_graph(10, 20, 2, 2, seed=1), 2,
                        device="cpu", wal=True)


def test_ooc_device_counts_on_the_path(tmp_path):
    """Device propagation over the out-of-core backend goes through the
    frontier fold at every level folded, and its builds through the
    chunk fold: on the CPU both take the plain versions (no launch), and
    the counters the card's run reads stay untouched."""
    calls = []
    from repro_torch.core import device_maint
    saved = device_maint._fold

    def fold(batch, tgt, *, dedup):
        calls.append(batch.e)
        return saved(batch, tgt, dedup=dedup)

    m = _port(gen.random_graph(60, 200, 3, 2, seed=4), 3, "device",
              tmp_path, backend_kw=dict(chunk_edges=32))
    device_maint._fold = fold
    try:
        rep = m.add_edges([0, 1], [1, 0], [5, 6])
    finally:
        device_maint._fold = saved
    assert rep.device and not rep.rebuilt
    assert len(calls) == sum(1 for c in rep.nodes_checked if c)
    assert tfold.sig_fold.launches == tfold.chunk_sig_fold.launches == 0
    m.backend.close()


# ------------------------------------------------------------ launcher
_TIMES = re.compile(r"\d+\.\d+(?=s|ms| ms)|_ms=\d+\.\d+")


def _lines(text: str, workdir) -> list:
    """Launcher output with its wall times and workdir blanked."""
    return [_TIMES.sub("T", ln).replace(str(workdir), "W")
            for ln in text.splitlines()]


@pytest.mark.parametrize("route", ROUTES)
def test_launcher_wal_and_recover_match_reference(capsys, tmp_path, route):
    """``--oocore --wal --workdir D add-edges --count N`` then ``recover``:
    the reference launcher's lines (levels, io delta, snapshot, recovered
    k/mode/nodes/tombstones/wal_lsn, recovery io, partitions)."""
    common = ["--generator", "random", "--nodes", "300", "--edges", "900",
              "--k", "4", "--seed", "3", "--oocore", "--io-threads", "0",
              "--chunk-edges", "128", "--spill-threshold", "64"]
    outs = []
    for who in ("ref", "mine"):
        wd = tmp_path / who
        ref_path = ["--device-maintenance"] if route == "device" else []
        my_path = [] if route == "device" else ["--host-maintenance"]
        for tail in (["--wal", "--workdir", str(wd), "add-edges",
                      "--count", "25"],
                     ["--workdir", str(wd), "recover"]):
            if who == "ref":
                ref_launcher._dispatch(ref_launcher.build_parser()
                                       .parse_args(common + ref_path + tail))
            else:
                launcher.main(["--device", "cpu"] + common + my_path + tail)
        outs.append(_lines(capsys.readouterr().out, wd))
    want, got = outs
    assert f"propagation={route}" in "\n".join(got)
    assert any(ln.startswith("recovered: k=4 mode=sorted nodes=300 "
                             "tombstones=0 wal_lsn=1") for ln in got)
    assert any(ln.startswith("io delta: ") for ln in got)
    assert got == want


def test_launcher_wal_needs_a_workdir(capsys):
    argv = ["--generator", "random", "--nodes", "50", "--edges", "100",
            "--oocore", "--wal", "add-edges"]
    with pytest.raises(SystemExit) as ref_exit:
        ref_launcher._dispatch(ref_launcher.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as mine:
        launcher.main(["--device", "cpu"] + argv)
    assert str(mine.value) == str(ref_exit.value)
    assert "--wal needs --oocore and --workdir" in str(mine.value)
    with pytest.raises(SystemExit, match="recover needs --oocore"):
        launcher.main(["--device", "cpu", "recover"])


_RATE = re.compile(r"= \d+ updates/s")
QUOTIENT_CASES = {
    "materialize": ["materialize", "--quotient-dir", "{wd}/q"],
    "query": ["query", "--path", "0:1", "--path", "1", "--point", "7",
              "--point", "0", "--batch", "2"],
    "query-update": ["query", "--path", "0:1", "--path", "1:0:1",
                     "--level", "3", "--point", "7", "--update", "8"],
    "query-loaded": ["query", "--quotient-dir", "{wd}/q", "--path", "0:1",
                     "--point", "7"],
    # batches close on their op count alone (a deadline of a minute), so
    # the batch and snapshot counts both launchers print do not hang on
    # the host's pace
    "serve-updates": ["--oocore", "--wal", "--workdir", "{wd}/s",
                      "--chunk-edges", "1024", "--io-threads", "0",
                      "serve-updates", "--ops", "40", "--batch-ops", "8",
                      "--batch-deadline-ms", "60000",
                      "--snapshot-every", "2"],
    "serve-updates-kill": ["--oocore", "--wal", "--workdir", "{wd}/s",
                           "--chunk-edges", "1024", "--io-threads", "0",
                           "serve-updates", "--ops", "40", "--batch-ops",
                           "8", "--batch-deadline-ms", "60000",
                           "--snapshot-every", "2", "--kill-at-op", "23"],
}


@pytest.mark.parametrize("case", sorted(QUOTIENT_CASES))
def test_launcher_quotient_and_stream_match_reference(capsys, tmp_path,
                                                      case):
    """``materialize``, ``query`` (fresh, with ``--update``, and from a
    loaded ``--quotient-dir``) and ``serve-updates`` (straight through
    and with the ``--kill-at-op`` crash drill): the reference launcher's
    lines, times and rates apart.  A loaded artifact is the other
    package's: each launcher serves the one its twin materialized."""
    common = ["--generator", "structured", "--nodes", "900", "--k", "4",
              "--seed", "3"]
    outs = []
    for who in ("ref", "mine"):
        wd = tmp_path / who
        other = tmp_path / ("mine" if who == "ref" else "ref")
        if case == "query-loaded":
            wd = other  # serve the other package's artifact
        argv = common + [a.format(wd=wd) for a in QUOTIENT_CASES[case]]
        if who == "ref":
            if case == "query-loaded":
                ref_launcher._dispatch(ref_launcher.build_parser(
                ).parse_args(common + ["materialize", "--quotient-dir",
                                       str(tmp_path / "mine" / "q")]))
                capsys.readouterr()
            ref_launcher._dispatch(ref_launcher.build_parser()
                                   .parse_args(argv))
        else:
            if case == "query-loaded":
                launcher.main(["--device", "cpu"] + common + [
                    "materialize", "--quotient-dir",
                    str(tmp_path / "ref" / "q")])
                capsys.readouterr()
            out = launcher.main(["--device", "cpu"] + argv)
        outs.append([_RATE.sub("= R updates/s", ln) for ln in
                     _lines(capsys.readouterr().out, wd)])
    want, got = outs
    assert got == want
    text = "\n".join(got)
    if case.startswith("serve"):
        assert "staleness: max=1 batches bound=1 OK" in text
    if case == "serve-updates":
        assert out["stats"]["applied_ops"] == 40
    if case == "serve-updates-kill":
        assert "recovery: pid history bit-identical" in text
        assert out["stats"]["applied_ops"] == 40 - out["survived"]
        for a, b in zip(out["pids"], out["ref_pids"]):
            np.testing.assert_array_equal(a, b)
    if case == "query-update":
        assert "patches=1, rematerializations=0" in text
        assert len(out) == 2


def test_launcher_quotient_and_stream_refusals(capsys, tmp_path):
    """The reference's refusals: serve-updates without its durable
    workdir, --update against a read-only artifact."""
    argv = ["--generator", "random", "--nodes", "50", "--edges", "100",
            "serve-updates"]
    with pytest.raises(SystemExit) as ref_exit:
        ref_launcher._dispatch(ref_launcher.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as mine:
        launcher.main(["--device", "cpu"] + argv)
    assert str(mine.value) == str(ref_exit.value)
    assert "serve-updates needs --oocore --wal --workdir" in str(mine.value)
    q = str(tmp_path / "q")
    launcher.main(["--device", "cpu", "--generator", "random", "--nodes",
                   "50", "--edges", "100", "--k", "2", "materialize",
                   "--quotient-dir", q])
    with pytest.raises(SystemExit, match="--update needs a live service"):
        launcher.main(["--device", "cpu", "query", "--quotient-dir", q,
                       "--update", "3"])
