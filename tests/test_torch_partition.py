"""The port's Build_Bisim vs the JAX package's, exactly.

Pid histories, counts, convergence, `next_pid`, the `IterationStats` byte
columns and the signature-store columns must be equal — not merely the
same partition up to renaming.  Inputs come from the generators, which
both packages run on the same numpy streams.
"""
import numpy as np
import pytest

from repro.core import build_bisim as jbuild
from repro.core import oracle_pids as joracle
from repro.graph import generators as jgen
from repro.graph.storage import paper_example_graph as jpaper

torch = pytest.importorskip("torch")
from repro_torch import obs  # noqa: E402
from repro_torch.core import (build_bisim, graph_from_numpy,  # noqa: E402
                              oracle_pids, partition_blocks, refines,
                              result_from_numpy, result_to_numpy,
                              same_partition)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.storage import Graph, paper_example_graph  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]
GRAPHS = {
    "random": lambda g: g.random_graph(120, 500, 4, 3, seed=11),
    "powerlaw": lambda g: g.powerlaw_graph(150, 700, 3, 2, seed=5),
    "dag": lambda g: g.random_dag(100, 380, 4, 2, seed=2),
    "structured": lambda g: g.structured_graph(40, seed=1),
    "dbest": lambda g: g.kary_tree(3, 4),
    "dworst": lambda g: g.complete_graph(9),
}


def _same_graph(tg, jg):
    for col in ("node_labels", "src", "dst", "elabel"):
        np.testing.assert_array_equal(getattr(tg, col), getattr(jg, col))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.pids, want.pids)
    assert got.pids.dtype == np.int32
    assert got.counts == want.counts
    assert got.converged_at == want.converged_at
    assert got.k_requested == want.k_requested
    assert got.next_pid == want.next_pid
    assert [(s.iteration, s.num_partitions, s.bytes_sorted, s.bytes_scanned)
            for s in got.stats] == \
        [(s.iteration, s.num_partitions, s.bytes_sorted, s.bytes_scanned)
         for s in want.stats]
    assert (got.stores is None) == (want.stores is None)
    for a, b in zip(got.stores or [], want.stores or []):
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.pids, b.pids)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", MODES)
def test_build_matches_reference(gname, mode):
    tg, jg = GRAPHS[gname](gen), GRAPHS[gname](jgen)
    _same_graph(tg, jg)
    want = jbuild(jg, 6, mode=mode)
    _assert_equal(build_bisim(tg, 6, mode=mode, device="cpu"), want)
    for sync_every in (1, 3):
        _assert_equal(build_bisim(tg, 6, mode=mode, fused=False,
                                  sync_every=sync_every, device="cpu"), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fused", [True, False])
def test_no_early_stop_matches_reference(mode, fused):
    tg, jg = GRAPHS["random"](gen), GRAPHS["random"](jgen)
    want = jbuild(jg, 7, mode=mode, early_stop=False, fused=fused)
    _assert_equal(build_bisim(tg, 7, mode=mode, early_stop=False,
                              fused=fused, device="cpu"), want)


@pytest.mark.parametrize("gname", ["random", "structured"])
@pytest.mark.parametrize("mode", MODES)
def test_store_columns_match_reference(gname, mode):
    tg, jg = GRAPHS[gname](gen), GRAPHS[gname](jgen)
    for sync_every in (1, 3):
        want = jbuild(jg, 6, mode=mode, with_store=True,
                      sync_every=sync_every)
        got = build_bisim(tg, 6, mode=mode, with_store=True,
                          sync_every=sync_every, device="cpu")
        assert got.stores is not None
        _assert_equal(got, want)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("with_store", [False, True])
def test_boundaries_k0_and_no_edges(k, with_store):
    labels = np.array([3, 1, 3, -2, 1], np.int32)
    empty = np.zeros(0, np.int32)
    tg = Graph(labels, empty, empty, empty)
    jg = jpaper().__class__(labels, empty, empty, empty)
    for g_t, g_j in ((tg, jg), (paper_example_graph(), jpaper())):
        want = jbuild(g_j, k, with_store=with_store)
        _assert_equal(build_bisim(g_t, k, with_store=with_store,
                                  device="cpu"), want)


def test_fused_with_store_and_bad_sync_every_raise():
    g = paper_example_graph()
    with pytest.raises(ValueError, match="fused"):
        build_bisim(g, 3, fused=True, with_store=True, device="cpu")
    with pytest.raises(ValueError, match="sync_every"):
        build_bisim(g, 3, sync_every=0, device="cpu")
    with pytest.raises(ValueError, match="unknown signature mode"):
        build_bisim(g, 3, mode="bogus", device="cpu")


def test_build_without_device_raises_without_a_card(monkeypatch):
    """The entry point runs on the card unless the CPU is asked for; it
    never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_bisim(paper_example_graph(), 2)


def test_paper_example_tables():
    """Table 1: k=0 -> 2 blocks, k=1 -> 4, k=2 -> 5, with its groupings."""
    res = build_bisim(paper_example_graph(), 2, early_stop=False,
                      device="cpu")
    assert res.counts == [2, 4, 5]
    b1 = partition_blocks(res.pids[1])
    assert sorted(map(sorted, b1.values())) == [[0, 1], [2, 4], [3], [5]]
    for j in range(1, 3):
        assert refines(res.pids[j], res.pids[j - 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_oracle_matches_reference_oracle_and_build(seed, mode):
    tg = gen.random_graph(40, 120, 3, 2, seed=seed)
    jg = jgen.random_graph(40, 120, 3, 2, seed=seed)
    counting = mode == "multiset"
    mine = oracle_pids(tg, 5, counting=counting, early_stop=False)
    theirs = joracle(jg, 5, counting=counting, early_stop=False)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    res = build_bisim(tg, 5, mode=mode, early_stop=False, device="cpu")
    for j in range(len(mine)):
        assert same_partition(res.pids[j], mine[j])


def test_state_round_trip():
    """A reference result's numpy fields become the port's and back."""
    jg = GRAPHS["powerlaw"](jgen)
    want = jbuild(jg, 5, with_store=True)
    fields = dict(pids=want.pids, counts=want.counts,
                  converged_at=want.converged_at,
                  k_requested=want.k_requested, next_pid=want.next_pid,
                  store_keys=[s.keys for s in want.stores],
                  store_pids=[s.pids for s in want.stores],
                  stats=want.stats)
    mine = result_from_numpy(**fields)
    _assert_equal(mine, want)
    back = result_to_numpy(mine)
    again = result_from_numpy(**{k: v for k, v in back.items()},
                              stats=want.stats)
    _assert_equal(again, want)
    tg = graph_from_numpy(jg.node_labels, jg.src, jg.dst, jg.elabel)
    _same_graph(tg, jg)
    _assert_equal(build_bisim(tg, 5, with_store=True, device="cpu"), mine)
    unconverged = result_to_numpy(build_bisim(tg, 1, device="cpu"))
    assert int(unconverged["converged_at"]) == -1
    assert result_from_numpy(**unconverged).converged_at is None


def test_trace_counts_dispatches_and_syncs():
    """One build.dispatch per iteration launched; build.sync per drain plus
    the history fetch, fewer with a larger sync_every."""
    g = GRAPHS["powerlaw"](gen)
    syncs = {}
    for sync_every in (1, 3):
        with obs.tracing() as tracer:
            res = build_bisim(g, 6, mode="multiset", fused=False,
                              sync_every=sync_every, device="cpu")
        steps = [e for e in tracer.find_events("build.dispatch")
                 if e["attrs"]["what"] == "step"]
        assert len(steps) >= res.k_effective
        syncs[sync_every] = len(tracer.find_events("build.sync"))
    assert syncs[1] > syncs[3] >= 2
    with obs.tracing() as tracer:
        res = build_bisim(g, 6, mode="multiset", device="cpu")
    dispatches = tracer.find_events("build.dispatch")
    assert {e["attrs"]["path"] for e in dispatches} == {"fused"}
    # fused: iteration 0 + each step, no more past the fixpoint than the
    # staged route with the same sync_every
    assert len(dispatches) <= res.k_effective + 2
