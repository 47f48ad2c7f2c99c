"""The port's out-of-core build (`repro_torch.exmem`) vs the JAX
package's (`repro.exmem`), on the CPU.

Both builds run from the same generated graphs; the port folds every
chunk through `chunk_sig_fold`'s plain version (``device="cpu"``), the
reference through its jnp fold.  Everything the build writes is integers,
so the bar is bit equality: every level's pid file, counts,
``converged_at`` and `IOStats.to_dict()` — also for a checkpointed build
killed at a fault point and resumed, and for the host-side pieces
(external sort, k-way merge, rebuffer, spillable store, the tables'
on-disk format) on their own.
"""
import os
import re

import numpy as np
import pytest

from repro.core import SpillableSigStore as RefSpillableSigStore
from repro.core import build_bisim as ref_build_bisim
from repro.core.kway import merge_sorted_sources as ref_merge
from repro.exmem import OocGraph as RefOocGraph
from repro.exmem import build_bisim_oocore as ref_oocore
from repro.exmem import runs as ref_runs
from repro.graph import generators as rgen
from repro.launch import bisim as ref_launcher

torch = pytest.importorskip("torch")
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.kway import merge_sorted_sources  # noqa: E402
from repro_torch.core.sig_store import SpillableSigStore  # noqa: E402
from repro_torch.exmem import (IOStats, OocGraph, build_bisim_oocore,  # noqa: E402
                               external_sort, make_records, rebuffer)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.storage import Graph, paper_example_graph  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]
# a subset of tests/test_exmem.py's GENERATORS (same sizes and seeds)
GENERATORS = {
    "random": ("random_graph", (120, 500, 3, 2), dict(seed=2)),
    "powerlaw": ("powerlaw_graph", (100, 420, 2, 2), dict(seed=3)),
    "structured": ("structured_graph", (40,), dict(seed=5)),
    "dworst": ("complete_graph", (12,), {}),
}


def _graphs(name):
    fn, args, kw = GENERATORS[name]
    return getattr(gen, fn)(*args, **kw), getattr(rgen, fn)(*args, **kw)


def _assert_same_build(mine, theirs):
    assert mine.counts == theirs.counts
    assert mine.converged_at == theirs.converged_at
    assert mine.io.to_dict() == theirs.io.to_dict()
    assert len(mine.pid_paths) == len(theirs.pid_paths)
    for j, (a, b) in enumerate(zip(mine.pid_paths, theirs.pid_paths)):
        pa, pb = np.load(a), np.load(b)
        assert pa.dtype == pb.dtype == np.int32
        np.testing.assert_array_equal(pa, pb, err_msg=f"level {j}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", sorted(GENERATORS))
def test_oocore_equals_reference(tmp_path, gname, mode):
    g, rg = _graphs(gname)
    kw = dict(mode=mode, chunk_edges=28, chunk_nodes=32, spill_threshold=16)
    mine = build_bisim_oocore(g, 4, workdir=str(tmp_path / "mine"),
                              device="cpu", **kw)
    theirs = ref_oocore(rg, 4, workdir=str(tmp_path / "ref"), **kw)
    assert OocGraph.load(str(tmp_path / "mine" / "graph")).num_edge_chunks \
        >= 4  # chunking actually forced
    _assert_same_build(mine, theirs)
    assert tfold.chunk_sig_fold.launches == 0  # the CPU takes the plain route


def test_oocore_paper_example(tmp_path):
    res = build_bisim_oocore(paper_example_graph(), 2, chunk_edges=2,
                             chunk_nodes=2, early_stop=False,
                             workdir=str(tmp_path), device="cpu")
    assert res.counts == [2, 4, 5]  # Table 1


@pytest.mark.parametrize("io_threads", [0, 1])
def test_oocore_kept_stores_equal_reference(tmp_path, io_threads):
    g, rg = _graphs("random")
    kw = dict(chunk_edges=64, chunk_nodes=32, spill_threshold=8,
              keep_stores=True, early_stop=False, io_threads=io_threads)
    mine = build_bisim_oocore(g, 3, workdir=str(tmp_path / "mine"),
                              device="cpu", **kw)
    theirs = ref_oocore(rg, 3, workdir=str(tmp_path / "ref"), **kw)
    _assert_same_build(mine, theirs)
    assert mine.next_pids == theirs.next_pids
    assert sum(s.num_spilled_runs for s in mine.stores) > 0
    for a, b in zip(mine.stores, theirs.stores):
        for x, y in zip(a.merged_arrays(), b.merged_arrays()):
            np.testing.assert_array_equal(x, y)


def test_oocore_matches_inmemory_reference_partition(tmp_path):
    """Counts and Change-k lookups agree with the reference's in-memory
    build (pids are equal up to renaming across the two engines)."""
    g, rg = _graphs("structured")
    res = build_bisim_oocore(g, 10, chunk_edges=128, workdir=str(tmp_path),
                             device="cpu")
    ref = ref_build_bisim(rg, 10)
    assert res.counts == ref.counts and res.converged_at == ref.converged_at
    a, b = res.pid_at(99), ref.pid_at(99)
    pairs = np.unique(np.stack([a, b]), axis=1)
    assert pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk_edges", [27, 30])
def test_oocore_odd_chunks_equal_reference(tmp_path, mode, chunk_edges):
    """Chunks whose lane counts are mostly not multiples of 4: each upload
    is padded to the kernel's vector width and folded into the chunk's
    distinct-source count, and the build still equals the reference's
    bit for bit."""
    g, rg = _graphs("powerlaw")
    kw = dict(mode=mode, chunk_edges=chunk_edges, chunk_nodes=32,
              spill_threshold=16)
    mine = build_bisim_oocore(g, 4, workdir=str(tmp_path / "mine"),
                              device="cpu", **kw)
    theirs = ref_oocore(rg, 4, workdir=str(tmp_path / "ref"), **kw)
    _assert_same_build(mine, theirs)


@pytest.mark.parametrize("mode", ["sorted", "multiset"])
def test_fold_call_site_uploads_n_lanes_into_u_rows(tmp_path, monkeypatch,
                                                    mode):
    """Every chunk uploads its n lanes rounded up to a multiple of
    `VEC` (pad lanes: seg = u, zero labels and pids), in one [3, width]
    block, and folds them into its u distinct sources."""
    from repro_torch.exmem import build as bmod
    uploads, folds = [], []
    real_upload, real_fold = bmod._upload, bmod.chunk_sig_fold

    def upload(lanes, device):
        uploads.append(lanes.copy())
        return real_upload(lanes, device)

    def fold(elabel, pid_tgt, seg, valid, keep0, *, num_segments, dedup):
        out = real_fold(elabel, pid_tgt, seg, valid, keep0,
                        num_segments=num_segments, dedup=dedup)
        folds.append((seg.numpy().copy(), valid.numpy().copy(),
                      num_segments, tuple(out.shape)))
        return out

    monkeypatch.setattr(bmod, "_upload", upload)
    monkeypatch.setattr(bmod, "chunk_sig_fold", fold)
    g, rg = _graphs("random")
    kw = dict(mode=mode, chunk_edges=27, chunk_nodes=32, spill_threshold=16)
    mine = build_bisim_oocore(g, 3, workdir=str(tmp_path / "mine"),
                              device="cpu", **kw)
    _assert_same_build(mine, ref_oocore(rg, 3, workdir=str(tmp_path / "ref"),
                                        **kw))
    assert len(uploads) == len(folds) > 0
    assert any(int((f[0] < f[2]).sum()) % tfold.VEC for f in folds)
    for lanes, (seg, valid, u, shape) in zip(uploads, folds):
        n = int((seg < u).sum())
        assert lanes.shape == (3, seg.size) and seg.size % tfold.VEC == 0
        assert 0 < n <= seg.size < n + tfold.VEC
        assert seg[0] == 0 and seg[n - 1] == u - 1
        assert set(np.diff(seg[:n]).tolist()) <= {0, 1}
        assert (seg[n:] == u).all() and (lanes[:2, n:] == 0).all()
        assert valid.all() and shape == (2, u)


# -------------------------------------------------- host-side pieces alone
@pytest.mark.parametrize("n,chunk,fan_in", [(0, 8, 4), (7, 3, 2),
                                            (1000, 64, 4), (1000, 7, 3)])
def test_external_sort_equals_reference(tmp_path, n, chunk, fan_in):
    rng = np.random.default_rng(n + chunk)
    cols = dict(a=rng.integers(0, 9, n).astype(np.int32),
                b=rng.integers(0, 5, n).astype(np.int32),
                c=rng.integers(0, 1 << 20, n).astype(np.int32))
    rec = make_records(cols)
    out = {}
    for name, sort, stats in (
            ("mine", external_sort, IOStats()),
            ("ref", ref_runs.external_sort, ref_runs.IOStats())):
        chunks = [rec[s:s + chunk] for s in range(0, n, chunk)]
        got = list(sort(chunks, ("a", "b", "c"), str(tmp_path / name),
                        budget_rows=chunk, fan_in=fan_in, stats=stats))
        out[name] = ([c.shape[0] for c in got], got, stats.to_dict())
    assert out["mine"][0] == out["ref"][0]
    for x, y in zip(out["mine"][1], out["ref"][1]):
        np.testing.assert_array_equal(x, y)
    assert out["mine"][2] == out["ref"][2]


@pytest.mark.parametrize("rows", [1, 4, 5, 64])
def test_rebuffer_and_kway_equal_reference(rows):
    rng = np.random.default_rng(rows)
    chunks = [np.arange(s, s + n, dtype=np.int64)
              for s, n in [(0, 3), (3, 1), (4, 0), (4, 10), (14, 2)]]
    mine = list(rebuffer(chunks, rows))
    theirs = list(ref_runs.rebuffer(chunks, rows))
    assert [c.tolist() for c in mine] == [c.tolist() for c in theirs]
    sources = []
    for n in (0, 1, 37, 150):
        k1, k2 = np.sort(rng.integers(0, 9, n)), rng.integers(0, 5, n)
        order = np.lexsort((k2, k1))
        sources.append((k1[order], k2[order], np.arange(n)))
    for a, b in zip(merge_sorted_sources(sources, 2, budget_rows=rows + 4),
                    ref_merge(sources, 2, budget_rows=rows + 4)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_spillable_store_equals_reference(tmp_path):
    rng = np.random.default_rng(5)
    stores = [cls(spill_threshold=6, spill_dir=str(tmp_path / name),
                  max_runs=2, io=io)
              for cls, name, io in ((SpillableSigStore, "mine", IOStats()),
                                    (RefSpillableSigStore, "ref",
                                     ref_runs.IOStats()))]
    nxt = [0, 0]
    for _ in range(12):
        keys = rng.integers(0, 60, 9).astype(np.uint64) << np.uint64(31)
        outs = []
        for i, s in enumerate(stores):
            pids, nxt[i] = s.get_or_assign(keys, nxt[i])
            outs.append(pids)
        np.testing.assert_array_equal(*outs)
    assert nxt[0] == nxt[1]
    mine, ref = stores
    assert mine.num_spilled_runs == ref.num_spilled_runs > 0
    assert mine.io.to_dict() == ref.io.to_dict()
    mine.flush()
    ref.flush()
    assert mine.state() == ref.state()
    adopted = SpillableSigStore(spill_threshold=6, spill_dir=mine.spill_dir)
    adopted.adopt_state(mine.state())
    probe = np.arange(0, 60, dtype=np.uint64) << np.uint64(31)
    for x, y in zip(adopted.lookup(probe), ref.lookup(probe)):
        np.testing.assert_array_equal(x, y)
    for s in stores:
        s.close()


@pytest.mark.parametrize("writer", ["mine", "ref"])
def test_tables_read_across_packages(tmp_path, writer):
    """Either package opens (and verifies) the other's table directory,
    and builds from it the same pid files."""
    g, rg = _graphs("powerlaw")
    root = str(tmp_path / "tables")
    if writer == "mine":
        g.to_ooc(root, chunk_nodes=32, chunk_edges=64)
    else:
        rg.to_ooc(root, chunk_nodes=32, chunk_edges=64)
    mine_tables, ref_tables = OocGraph.load(root), RefOocGraph.load(root)
    back = mine_tables.to_memory()
    for x, y in zip((back.node_labels, back.src, back.dst, back.elabel),
                    (g.node_labels, g.src, g.dst, g.elabel)):
        np.testing.assert_array_equal(x, y)
    mine = build_bisim_oocore(mine_tables, 3, workdir=str(tmp_path / "m"),
                              device="cpu")
    theirs = ref_oocore(ref_tables, 3, workdir=str(tmp_path / "r"))
    _assert_same_build(mine, theirs)


# ---------------------------------------------------- checkpoint / resume
def test_checkpoint_resume_from_kill_points(tmp_path):
    """Kill the port's checkpointed build at every 7th injected fault
    point (plus the first and last), resume, and demand the reference's
    clean pid files bit for bit (the graph and geometry of the reference's
    own sweep in tests/test_durability.py)."""
    g = gen.random_graph(60, 170, 3, 2, seed=7)
    rg = rgen.random_graph(60, 170, 3, 2, seed=7)
    kw = dict(chunk_edges=32, chunk_nodes=24, io_threads=0)
    ref = ref_oocore(rg, 3, workdir=str(tmp_path / "ref"), **kw)
    ref_pids = [np.load(p) for p in ref.pid_paths]
    with faults.install_fault_plan(faults.FaultPlan()) as seen:
        build_bisim_oocore(g, 3, workdir=str(tmp_path / "obs"),
                           checkpoint=True, device="cpu", **kw)
    total = seen.points_seen
    assert total > 20
    for n in sorted({1, total} | set(range(4, total, 7))):
        wd = str(tmp_path / f"kill_{n:04d}")
        with faults.install_fault_plan(faults.FaultPlan(crash_at=n)):
            with pytest.raises(faults.InjectedCrash):
                build_bisim_oocore(g, 3, workdir=wd, checkpoint=True,
                                   device="cpu", **kw)
        res = build_bisim_oocore(g, 3, workdir=wd, checkpoint=True,
                                 resume=True, device="cpu", **kw)
        assert res.converged_at == ref.converged_at, n
        assert res.counts == ref.counts, n
        for j, want in enumerate(ref_pids):
            np.testing.assert_array_equal(np.load(res.pid_paths[j]), want,
                                          err_msg=f"kill {n}, level {j}")
        assert res.io.sort_cost >= ref.io.sort_cost, n
        assert res.io.scan_cost >= ref.io.scan_cost, n


def test_checkpoint_needs_workdir_and_matching_params(tmp_path):
    g, _ = _graphs("random")
    with pytest.raises(ValueError, match="workdir"):
        build_bisim_oocore(g, 2, checkpoint=True, device="cpu")
    wd = str(tmp_path / "b")
    build_bisim_oocore(g, 2, chunk_edges=32, workdir=wd, checkpoint=True,
                       io_threads=0, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        build_bisim_oocore(g, 2, chunk_edges=64, workdir=wd,
                           checkpoint=True, resume=True, io_threads=0,
                           device="cpu")


def test_oocore_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_bisim_oocore(Graph.from_edges(np.zeros(2, np.int32),
                                            np.zeros(0, np.int32),
                                            np.zeros(0, np.int32),
                                            np.zeros(0, np.int32)), 1,
                           workdir=str(tmp_path))
    assert not os.listdir(str(tmp_path))  # raised before writing


# ---------------------------------------------------------------- launcher
def _stable_lines(text):
    """The launcher's output without its clock readings."""
    text = re.sub(r" +[\d.]+ ms", " _ ms", text)
    text = re.sub(r"total [\d.]+s", "total _s", text)
    return [ln for ln in text.splitlines()
            if not ln.startswith(("overlap:", "workdir:", "saved "))]


def test_launcher_oocore_on_cpu_equals_reference(tmp_path, capsys,
                                                 monkeypatch):
    argv = ["--oocore", "--generator", "structured", "--nodes", "900",
            "--k", "4", "--chunk-edges", "256", "--io-threads", "0"]
    out = tmp_path / "pids.npz"
    launcher.main(argv + ["--device", "cpu", "--out", str(out)])
    mine = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["bisim"] + argv)
    ref_launcher.main()
    theirs = capsys.readouterr().out
    assert "k=4 mode=sorted oocore" in mine
    assert re.search(r"^io: sort_cost=\d+ scan_cost=\d+", mine, re.M)
    assert _stable_lines(mine) == _stable_lines(theirs)
    with np.load(out) as z:
        assert sorted(z.files) == [f"pids_{j}" for j in range(len(z.files))]
        assert len(z.files) >= 2
