"""The port's quotient engine (`repro_torch.quotient`) against the JAX
package's (`repro.quotient`), on the CPU.

The generators, the query suite and its random walks are those of
`tests/test_quotient.py`, imported unchanged.  Every query goes through
four evaluators: the port's `QuotientEngine` (``device="cpu"``: the
wave's hops in plain PyTorch), the JAX `QuotientEngine`, the port's
`eval_ref` and the port's `eval_brute` on the original graph, and all
must agree exactly.  Everything else this slice writes is integers, so
the bar is equality with the reference: artifact files byte for byte
(either package loads the other's), engine ``stats``, epochs, extent
runs, `IOStats` of materialization and of a patch, and a patched index
answering as a rematerialized one.  Card cases live in
`tests/test_torch_kernels_gpu.py`, which imports no JAX.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.core import BisimMaintainer as RefMaintainer
from repro.exmem import OocBackend as RefOocBackend
from repro.exmem.durability import ChecksumError as RefChecksumError
from repro.quotient import ExtentRuns as RefExtentRuns
from repro.quotient import LabelPath as RefLabelPath
from repro.quotient import QuotientEngine as RefEngine
from repro.quotient import QuotientIndex as RefIndex
from repro.quotient import QuotientService as RefService
from repro.quotient import materialize_quotient as ref_materialize
from repro.quotient import normalize_query as ref_normalize_query
from test_quotient import GENERATORS, K, MODES, _query_suite

torch = pytest.importorskip("torch")
from repro_torch import quotient as tq  # noqa: E402
from repro_torch.core import BisimMaintainer  # noqa: E402
from repro_torch.exmem import OocBackend  # noqa: E402
from repro_torch.exmem.durability import ChecksumError  # noqa: E402
from repro_torch.graph.storage import Graph  # noqa: E402


def _port_graph(g) -> Graph:
    return Graph(g.node_labels, g.src, g.dst, g.elabel)


def _port_query(q):
    """The port's twin of a reference query dataclass."""
    return getattr(tq, type(q).__name__)(**dataclasses.asdict(q))


def _both(gname, mode, k=K):
    g = GENERATORS[gname]()
    return (BisimMaintainer(_port_graph(g), k, mode=mode, device="cpu"),
            RefMaintainer(g, k, mode=mode))


def _materialize_both(tmp_path, m, ref_m, name="q"):
    idx = tq.materialize_quotient(
        m.graph, m.backend, str(tmp_path / "port" / name),
        counts=[int(x) for x in m.next_pid], mode=m.mode)
    ref_idx = ref_materialize(
        ref_m.graph, ref_m.backend, str(tmp_path / "ref" / name),
        counts=[int(x) for x in ref_m.next_pid], mode=ref_m.mode)
    return idx, ref_idx


def _files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _assert_same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        assert fa[rel] == fb[rel], rel


def _same_answer(a, b, ctx):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, ctx
        np.testing.assert_array_equal(a, b, err_msg=str(ctx))
    else:
        assert dataclasses.astuple(a) == dataclasses.astuple(b), ctx


def _check_all(engine, index, graph, hist, queries, ref_engine, ctx=()):
    """Port engine == JAX engine == port eval_ref == port eval_brute."""
    got = engine.query([_port_query(q) for q in queries])
    want = ref_engine.query(queries)
    for q, a, w in zip(queries, got, want):
        pq = _port_query(q)
        _same_answer(a, w, (*ctx, "engine vs JAX engine", q))
        _same_answer(a, tq.eval_ref(index, pq), (*ctx, "engine vs ref", q))
        _same_answer(a, tq.eval_brute(graph, pq, hist),
                     (*ctx, "engine vs brute", q))


def _hist(m):
    return [m.backend.pid_column(j) for j in range(m.k + 1)]


# ----------------------------------------------- four-way differential
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_engine_ref_brute_agree(tmp_path, gname, mode):
    """test_quotient's three-way differential through the port, plus the
    JAX engine, the artifact files and the engine stats."""
    m, ref_m = _both(gname, mode)
    idx, ref_idx = _materialize_both(tmp_path, m, ref_m)
    _assert_same_files(idx.root, ref_idx.root)
    engine = tq.QuotientEngine(idx, max_batch=4, device="cpu")
    ref_engine = RefEngine(ref_idx, max_batch=4)  # several waves
    queries = _query_suite(ref_m.graph, np.random.default_rng(17), K)
    _check_all(engine, idx, m.graph, _hist(m), queries, ref_engine,
               ctx=(gname, mode))
    assert engine.stats == ref_engine.stats
    assert engine.stats["waves"] >= 1 and engine.stats["hops"] >= 1


@pytest.mark.parametrize("hop_elems", [1, 7, tq.engine.HOP_ELEMS])
def test_engine_batching_is_order_and_width_invariant(tmp_path, monkeypatch,
                                                      hop_elems):
    """max_batch 1 and 64 (shuffled), and any edge tiling of a hop, give
    the same answers slot for slot; stats equal the JAX engine's."""
    monkeypatch.setattr(tq.engine, "HOP_ELEMS", hop_elems)
    m, ref_m = _both("powerlaw", "sorted")
    idx, ref_idx = _materialize_both(tmp_path, m, ref_m)
    rng = np.random.default_rng(23)
    queries = [q for q in _query_suite(ref_m.graph, rng, K)
               if type(q).__name__ != "PointLookup"]
    perm = rng.permutation(len(queries))
    narrow = tq.QuotientEngine(idx, max_batch=1, device="cpu")
    wide = tq.QuotientEngine(idx, max_batch=64, device="cpu")
    a1 = narrow.query([_port_query(q) for q in queries])
    a2 = wide.query([_port_query(queries[i]) for i in perm])
    for slot, i in enumerate(perm):
        np.testing.assert_array_equal(a1[i], a2[slot])
    assert narrow.stats["waves"] > wide.stats["waves"]
    for eng, width, order in ((narrow, 1, range(len(queries))),
                              (wide, 64, perm)):
        ref = RefEngine(ref_idx, max_batch=width)
        ref.query([queries[i] for i in order])
        assert eng.stats == ref.stats


@pytest.mark.parametrize("case", [
    ((), 2), ((0, 1, 2), 2), ((0,), K + 1), ((-1,), 1), "not a query"])
def test_normalize_query_validation(case):
    """The port raises where the reference raises, with its message."""
    if isinstance(case, str):
        with pytest.raises(TypeError):
            ref_normalize_query(case, K)
        with pytest.raises(TypeError):
            tq.normalize_query(case, K)
        return
    labels, level = case
    with pytest.raises(ValueError) as want:
        ref_normalize_query(RefLabelPath(labels, level=level), K)
    with pytest.raises(ValueError) as got:
        tq.normalize_query(tq.LabelPath(labels, level=level), K)
    assert str(got.value) == str(want.value)


def test_normalize_query_defaults_and_constraints():
    assert tq.normalize_query(tq.LabelPath((0, 1)), K) == \
        ((0, 1), None, None, 2)   # default: the smallest exact level
    assert tq.normalize_query(
        tq.ReachTemplate((1,), src_label=0, tgt_label=2, level=3), K) == \
        ((1,), 0, 2, 3)
    with pytest.raises(ValueError, match="label constraints"):
        tq.normalize_query(tq.ReachTemplate((1,), src_label=-1), K)
    # the padding and unconstrained sentinels can never equal a label
    assert tq.queries.WANT_ALL < -1 and tq.queries.WANT_NONE < -1
    assert tq.queries.WANT_ALL != tq.queries.WANT_NONE


# -------------------------------------------------------- extent runs
def _same_runs(a, b, ctx=()):
    np.testing.assert_array_equal(a.start, b.start, err_msg=str(ctx))
    np.testing.assert_array_equal(a.pid, b.pid, err_msg=str(ctx))
    assert a.start.dtype == b.start.dtype and a.pid.dtype == b.pid.dtype
    assert (a.num_nodes, a.n_blocks) == (b.num_nodes, b.n_blocks), ctx


@pytest.mark.parametrize("seed", [31, 32])
def test_extent_runs_roundtrip_and_splice_fuzz(seed):
    """test_quotient's fuzz through both packages: encode, lookup,
    expansion and splice equal the reference's runs and a naive
    recomputation."""
    rng = np.random.default_rng(seed)
    for it in range(20):
        n = int(rng.integers(1, 200))
        n_blocks = int(rng.integers(1, 12))
        col = rng.integers(0, n_blocks, n).astype(np.int64)
        window = int(rng.integers(3, 40))
        runs = tq.ExtentRuns.from_column(col, n, n_blocks, window=window)
        ref = RefExtentRuns.from_column(col, n, n_blocks, window=window)
        _same_runs(runs, ref, (seed, it))
        ids = rng.integers(0, n, min(n, 13)).astype(np.int64)
        np.testing.assert_array_equal(runs.pid_of(ids), col[ids])
        for b in range(n_blocks):
            np.testing.assert_array_equal(
                runs.expand([b]), np.flatnonzero(col == b))
            assert runs.block_size(b) == int((col == b).sum())
        for size in (0, 2, n_blocks):
            blocks = rng.permutation(n_blocks)[:size]
            got, want = runs.expand(blocks), ref.expand(blocks)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        grow = int(rng.integers(0, 5))
        pick = np.unique(np.concatenate(
            [rng.integers(0, n, 3), np.arange(n, n + grow)]))
        vals = rng.integers(0, n_blocks + 2, pick.size).astype(np.int64)
        n2 = n + grow
        col2 = np.concatenate([col, np.zeros(n2 - n, np.int64)])
        col2[pick] = vals
        spliced = runs.splice(pick, vals, num_nodes=n2,
                              n_blocks=n_blocks + 2)
        _same_runs(spliced, ref.splice(pick, vals, num_nodes=n2,
                                       n_blocks=n_blocks + 2), (seed, it))
        np.testing.assert_array_equal(spliced.pid_of(np.arange(n2)), col2)
        assert spliced.start[0] == 0
        assert np.all(np.diff(spliced.start) > 0)
        assert np.all(spliced.pid[1:] != spliced.pid[:-1])


def test_extent_runs_splice_rejects_gap():
    runs = tq.ExtentRuns.from_column(np.zeros(4, np.int64), 4, 1)
    with pytest.raises(ValueError, match="gap"):
        runs.splice(np.array([6]), np.array([0]), num_nodes=7)
    with pytest.raises(ValueError, match="out of range"):
        runs.pid_of([4])


# ------------------------------------------------- artifact durability
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_artifact_reload_and_torn_file_rejection(tmp_path, writer):
    """Either package's artifact loads in the port (equal to the other's
    load), and a bit flip in a top-level run file is rejected."""
    m, ref_m = _both("random", "sorted")
    idx, ref_idx = _materialize_both(tmp_path, m, ref_m)
    root = idx.root if writer == "port" else ref_idx.root
    re = tq.QuotientIndex.load(root, verify=True)
    ref_re = RefIndex.load(root, verify=True)
    assert re.counts == ref_re.counts == idx.counts and re.k == K
    for j in range(1, K + 1):
        for f in ("src", "elabel", "dst"):
            np.testing.assert_array_equal(getattr(re.levels[j], f),
                                          getattr(ref_re.levels[j], f))
    for j in range(K + 1):
        _same_runs(re.runs[j], ref_re.runs[j], j)
        np.testing.assert_array_equal(re.labels[j], ref_re.labels[j])
    with open(os.path.join(root, "runs_pid_2.npy"), "r+b") as f:
        f.seek(-2, os.SEEK_END)
        f.write(b"\xff\xff")
    with pytest.raises(ChecksumError):
        tq.QuotientIndex.load(root, verify=True)
    with pytest.raises(RefChecksumError):
        RefIndex.load(root, verify=True)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_artifact_rejects_torn_level_chunk(tmp_path, writer):
    m, ref_m = _both("structured", "sorted")
    idx, ref_idx = _materialize_both(tmp_path, m, ref_m)
    root = idx.root if writer == "port" else ref_idx.root
    victim = os.path.join(root, "level_01", "edges_tst",
                          "chunk_000000.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(ChecksumError):
        tq.QuotientIndex.load(root, verify=True)


def test_materialize_refuses_an_existing_dir_and_bad_counts(tmp_path):
    m, _ = _both("random", "sorted")
    root = str(tmp_path / "q")
    tq.materialize_quotient(m.graph, m.backend, root)
    with pytest.raises(FileExistsError):
        tq.materialize_quotient(m.graph, m.backend, root)
    with pytest.raises(ValueError, match="counts"):
        tq.materialize_quotient(m.graph, m.backend, root, overwrite=True,
                                counts=[1] * (K + 1))


# --------------------------------------- liveness / staleness contract
def _draw_and_apply(svcs, m_ref, rng):
    """One update from ``rng`` applied through every service."""
    n = m_ref.backend.num_nodes
    cnt = int(rng.integers(1, 5))
    op = int(rng.integers(0, 3))
    if op == 0:
        args = (rng.integers(0, n, cnt).astype(np.int32),
                rng.integers(0, 3, cnt).astype(np.int32),
                rng.integers(0, n, cnt).astype(np.int32))
        for s in svcs:
            s.add_edges(*args)
    elif op == 1 and m_ref.graph.num_edges:
        g = m_ref.graph
        take = rng.integers(0, g.num_edges, min(3, g.num_edges))
        for s in svcs:
            s.delete_edges(g.src[take], g.elabel[take], g.dst[take])
    else:
        labels = rng.integers(0, 3, cnt)
        for s in svcs:
            s.add_nodes(labels)


def _assert_patched_is_fresh(tmp_path, svc, queries, tag):
    """The patched artifact answers as a freshly materialized one."""
    m = svc.m
    oracle = tq.materialize_quotient(
        m.graph, m.backend, str(tmp_path / f"oracle_{tag}"),
        counts=[int(x) for x in m.next_pid], mode=m.mode)
    for q in queries:
        pq = _port_query(q)
        _same_answer(tq.eval_ref(svc.index, pq), tq.eval_ref(oracle, pq),
                     ("patched vs fresh", tag, q))


@pytest.mark.parametrize("mode", MODES)
def test_service_staleness_contract_inmemory(tmp_path, mode):
    """test_quotient's interleaved update/query stream through the port's
    and the JAX `QuotientService`: epochs advance once a batch in both,
    answers equal both engines, eval_ref and brute force, the patched
    artifact answers as a fresh one, and its files equal the JAX
    service's after every patch."""
    m, ref_m = _both("random", mode)
    svc = tq.QuotientService(m, str(tmp_path / "port"), max_batch=8)
    ref_svc = RefService(ref_m, str(tmp_path / "ref"), max_batch=8)
    assert svc.engine.device == torch.device("cpu")
    rng = np.random.default_rng(47)
    for step in range(4):
        before = svc.epoch
        _draw_and_apply((svc, ref_svc), ref_m, rng)
        assert svc.epoch == ref_svc.epoch == before + 1
        assert svc.engine.epoch == svc.epoch
        assert (svc.patches, svc.rematerializations) == \
            (ref_svc.patches, ref_svc.rematerializations)
        queries = _query_suite(ref_m.graph, rng, m.k)
        _check_all(svc.engine, svc.index, m.graph, _hist(m), queries,
                   ref_svc.engine, ctx=("stream", step))
        _assert_same_files(svc.root, ref_svc.root)
        _assert_patched_is_fresh(tmp_path, svc, queries, step)
    assert svc.patches >= 1
    assert svc.engine.stats == ref_svc.engine.stats


def _ooc_pair(tmp_path, gname="structured"):
    kw = dict(chunk_edges=64, chunk_nodes=48)
    backend = OocBackend(_port_graph(GENERATORS[gname]()), device="cpu",
                         workdir=str(tmp_path / "b-port"), **kw)
    ref_backend = RefOocBackend(GENERATORS[gname](),
                                workdir=str(tmp_path / "b-ref"), **kw)
    return (BisimMaintainer(backend, K, mode="sorted"),
            RefMaintainer(ref_backend, K, mode="sorted"))


def test_service_patch_cost_stays_incremental_ooc(tmp_path):
    """On the disk backend a small batch goes down the patch path and
    costs a fraction of the materialization, and both `IOStats` (the
    service's and the backend's) equal the JAX service's, charge for
    charge; the patched index answers as a rematerialized one."""
    m, ref_m = _ooc_pair(tmp_path)
    svc = tq.QuotientService(m, str(tmp_path / "svc-port"), max_batch=8)
    ref_svc = RefService(ref_m, str(tmp_path / "svc-ref"), max_batch=8)
    assert svc.io.to_dict() == ref_svc.io.to_dict()
    mat_sort = svc.io.sort_cost
    assert mat_sort > 0
    edges = (np.array([1, 5], np.int32), np.array([0, 1], np.int32),
             np.array([9, 3], np.int32))
    svc.add_edges(*edges)
    ref_svc.add_edges(*edges)
    assert svc.io.to_dict() == ref_svc.io.to_dict()
    assert m.backend.io.to_dict() == ref_m.backend.io.to_dict()
    assert svc.patches == 1 and svc.rematerializations == 0
    assert svc.io.sort_cost - mat_sort < mat_sort
    queries = _query_suite(ref_m.graph, np.random.default_rng(3), K)
    _check_all(svc.engine, svc.index, m.graph, _hist(m), queries,
               ref_svc.engine, ctx=("ooc-patch",))
    _assert_same_files(svc.root, ref_svc.root)
    _assert_patched_is_fresh(tmp_path, svc, queries, "ooc")
    m.backend.close()
    ref_m.backend.close()


def test_service_rematerializes_on_compact_and_change_k(tmp_path):
    """compact and change_k move ids or the level ladder: both services
    rematerialize at the same epochs and still serve exact answers."""
    m, ref_m = _both("random", "sorted")
    svc = tq.QuotientService(m, str(tmp_path / "port"), max_batch=8)
    ref_svc = RefService(ref_m, str(tmp_path / "ref"), max_batch=8)
    rng = np.random.default_rng(5)
    for s in (svc, ref_svc):
        s.delete_node(3)
        s.compact()
    assert svc.rematerializations == ref_svc.rematerializations >= 1
    for s in (svc, ref_svc):
        s.change_k(2)
    assert svc.index.k == 2 and svc.engine.epoch == svc.epoch
    assert (svc.epoch, svc.rematerializations) == \
        (ref_svc.epoch, ref_svc.rematerializations)
    queries = _query_suite(ref_m.graph, rng, 2)
    _check_all(svc.engine, svc.index, m.graph, _hist(m), queries,
               ref_svc.engine, ctx=("remat",))
    _assert_same_files(svc.root, ref_svc.root)


def test_artifacts_load_across_packages(tmp_path):
    """A JAX-materialized artifact served by the port's engine, and the
    port's served by the JAX engine, answer as their own packages do."""
    m, ref_m = _both("powerlaw", "dedup_hash")
    idx, ref_idx = _materialize_both(tmp_path, m, ref_m)
    queries = _query_suite(ref_m.graph, np.random.default_rng(9), K)
    mine_on_ref = tq.QuotientEngine(tq.QuotientIndex.load(ref_idx.root),
                                    max_batch=16, device="cpu")
    ref_on_mine = RefEngine(RefIndex.load(idx.root), max_batch=16)
    _check_all(mine_on_ref, idx, m.graph, _hist(m), queries, ref_on_mine,
               ctx=("cross",))
    assert mine_on_ref.stats == ref_on_mine.stats


# ------------------------------------------------------ backend gathers
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_inmemory_backend_gathers_match_reference(gname):
    m, ref_m = _both(gname, "sorted")
    rng = np.random.default_rng(11)
    n = m.backend.num_nodes
    for size in (0, 1, 5, n):
        nodes = np.unique(rng.integers(0, n, size)).astype(np.int64)
        for a, b in zip(m.backend.out_edges_of(nodes),
                        ref_m.backend.out_edges_of(nodes)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        a = m.backend.node_labels_of(nodes)
        b = ref_m.backend.node_labels_of(nodes)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- no fallback
def test_engine_refuses_without_a_card(monkeypatch, tmp_path):
    m, _ = _both("random", "sorted")
    idx = tq.materialize_quotient(m.graph, m.backend, str(tmp_path / "q"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.QuotientEngine(idx, device=asked)


def test_engine_hop_failure_raises(monkeypatch, tmp_path):
    """A failing hop raises out of `query`: no host evaluator steps in."""
    m, _ = _both("random", "sorted")
    idx = tq.materialize_quotient(m.graph, m.backend, str(tmp_path / "q"))
    engine = tq.QuotientEngine(idx, device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("hop failed")

    monkeypatch.setattr(tq.engine, "_hop", broken)
    with pytest.raises(RuntimeError, match="hop failed"):
        engine.query([tq.LabelPath((0,), level=1)])
    assert engine.stats["queries"] == 0
