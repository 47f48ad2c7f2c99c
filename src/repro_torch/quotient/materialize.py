"""Quotient materialization: per-level Q_j from a (graph, pid history)
pair, persisted as an `OocGraph`-backed artifact directory.

The port's copy of `repro.quotient.materialize` over the port's
`exmem` (host numpy, the reference's byte layout: either package loads
the other's artifact).  `ExtentRuns`' block index and expansion are
vectorised (one stable sort of a fused key, one gather in place of a
per-block concatenate): the same outputs, without a Python loop over
the blocks of an answer.

One sort(E) pass per level: the edge stream (E_tst order) is mapped to
(pId_j(src), eLabel, pId_{j-1}(dst)) records, pushed through
`exmem.runs.external_sort` (which merges via the shared `core/kway.py`
emit-boundary core), adjacent-deduplicated, and written as a per-level
`OocGraph`.  Extents are the pId_j column run-length encoded into
sorted node-id runs (`ExtentRuns` — see the package docstring for the
format).  The artifact directory:

    out_dir/
      manifest.json        top-level Manifest: meta (k, mode, counts,
                           num_nodes, epoch) + checksums of every run
                           and label array — written LAST (commit point)
      labels_<j>.npy       int32 [counts[j]] block labels, -1 = vacated
      runs_start_<j>.npy   int64, ascending, tiles [0, N)     (j = 0..k)
      runs_pid_<j>.npy     int64, pid of each run
      level_<j>/           OocGraph for Q_j                    (j = 1..k)

Loading re-verifies every checksum (and each level graph's own
manifest), so a torn or bit-flipped artifact is rejected at open —
the same contract as every other persistent artifact in the repo.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..exmem import aio as aio_mod
from ..exmem.durability import ChecksumError, Manifest
from ..exmem.runs import IOStats, external_sort, make_records
from ..exmem.tables import OocGraph
from ..graph.storage import Graph, lexsort_order
from ..obs import tracer as obs

_PID_LIMIT = np.iinfo(np.int32).max


# --------------------------------------------------------------- extents
@dataclasses.dataclass
class ExtentRuns:
    """The pId_j column as sorted node-id runs: run r covers node ids
    [start[r], start[r+1]) (the last run ends at num_nodes) and every
    node in it has pid[r].  `start` is strictly increasing and tiles
    [0, num_nodes) exactly."""

    start: np.ndarray   # int64 [R], ascending, start[0] == 0 when N > 0
    pid: np.ndarray     # int64 [R]
    num_nodes: int
    n_blocks: int

    def __post_init__(self):
        self.start = np.asarray(self.start, dtype=np.int64)
        self.pid = np.asarray(self.pid, dtype=np.int64)
        self._order: Optional[np.ndarray] = None
        self._off: Optional[np.ndarray] = None

    @classmethod
    def from_column(cls, pid_col, num_nodes: int, n_blocks: int, *,
                    window: int = 1 << 18,
                    stats: Optional[IOStats] = None) -> "ExtentRuns":
        """Run-length encode a pid column (array or memmap) with
        windowed sequential reads."""
        parts_s: List[np.ndarray] = []
        parts_p: List[np.ndarray] = []
        prev_last = None
        for s in range(0, num_nodes, window):
            w = np.asarray(pid_col[s:s + window]).astype(np.int64)
            if stats is not None:
                stats.count_scan(w.shape[0], w.nbytes)
            if w.shape[0] == 0:
                continue
            idx = np.concatenate(
                [[0], np.flatnonzero(w[1:] != w[:-1]) + 1])
            if prev_last is not None and w[0] == prev_last:
                idx = idx[1:]  # continues the previous window's run
            parts_s.append(idx + s)
            parts_p.append(w[idx])
            prev_last = w[-1]
        if parts_s:
            start = np.concatenate(parts_s)
            pid = np.concatenate(parts_p)
        else:
            start = np.empty(0, np.int64)
            pid = np.empty(0, np.int64)
        return cls(start, pid, int(num_nodes), int(n_blocks))

    # ------------------------------------------------------------- lookups
    def _index(self):
        """Lazy (pid, start)-grouped view: run indices ordered by pid,
        plus per-pid offsets (CSR over runs)."""
        if self._order is None:
            # np.lexsort's permutation, by one stable sort of a fused key
            self._order = lexsort_order((self.start, self.pid))
            self._off = np.searchsorted(self.pid[self._order],
                                        np.arange(self.n_blocks + 1))
        return self._order, self._off

    def ends(self) -> np.ndarray:
        return np.append(self.start[1:], self.num_nodes)

    def pid_of(self, node_ids) -> np.ndarray:
        """pId of each node id — one searchsorted over the run starts."""
        ids = np.atleast_1d(np.asarray(node_ids, dtype=np.int64))
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
            raise ValueError("node id out of range")
        return self.pid[np.searchsorted(self.start, ids, side="right") - 1]

    def block_size(self, block_id: int) -> int:
        order, off = self._index()
        runs = order[off[block_id]:off[block_id + 1]]
        if runs.size == 0:
            return 0
        ends = self.ends()
        return int((ends[runs] - self.start[runs]).sum())

    def expand(self, block_ids) -> np.ndarray:
        """Ascending node ids of every member of the given blocks."""
        block_ids = np.atleast_1d(np.asarray(block_ids, dtype=np.int64))
        order, off = self._index()
        # each block's slice of `order`, concatenated in block order (one
        # vectorised gather: the reference's per-block concatenate)
        first, n_runs = off[block_ids], off[block_ids + 1] - off[block_ids]
        total_runs = int(n_runs.sum())
        if total_runs == 0:
            return np.empty(0, np.int64)
        runs = order[np.arange(total_runs, dtype=np.int64) + np.repeat(
            first - (np.cumsum(n_runs) - n_runs), n_runs)]
        starts = self.start[runs]
        lens = self.ends()[runs] - starts
        total = int(lens.sum())
        # concatenated aranges: arange(total) rebased per run
        cum = np.cumsum(lens) - lens
        out = (np.arange(total, dtype=np.int64)
               - np.repeat(cum, lens) + np.repeat(starts, lens))
        out.sort()  # runs of different blocks interleave in id space
        return out

    # -------------------------------------------------------------- splice
    def splice(self, node_ids: np.ndarray, new_pids: np.ndarray, *,
               num_nodes: Optional[int] = None,
               n_blocks: Optional[int] = None) -> "ExtentRuns":
        """A new ExtentRuns with `node_ids` (sorted unique) reassigned to
        `new_pids`.  Only the runs overlapping changed id intervals are
        rewritten; ids at/past the current end extend the column (node
        appends).  Cost O(changed + affected runs), never a column
        re-encode."""
        ids = np.asarray(node_ids, dtype=np.int64)
        vals = np.asarray(new_pids, dtype=np.int64)
        n_new = int(num_nodes if num_nodes is not None else
                    max(self.num_nodes, (ids.max() + 1) if ids.size else 0))
        if ids.size == 0:
            return ExtentRuns(self.start.copy(), self.pid.copy(), n_new,
                              int(n_blocks or self.n_blocks))
        brk = np.flatnonzero(np.diff(ids) != 1) + 1
        seg_lo = np.concatenate([[0], brk])
        seg_hi = np.append(brk, ids.size)
        res_s: List[np.ndarray] = []
        res_p: List[np.ndarray] = []

        def emit_old(a: int, b: int) -> None:
            b = min(b, self.num_nodes)
            if a >= b:
                return
            lo = np.searchsorted(self.start, a, side="right") - 1
            hi = np.searchsorted(self.start, b, side="left")
            s = self.start[lo:hi].copy()
            s[0] = a  # clip the head run at the interval boundary
            res_s.append(s)
            res_p.append(self.pid[lo:hi])

        prev_end = 0
        for si in range(seg_lo.size):
            a = int(ids[seg_lo[si]])
            b = int(ids[seg_hi[si] - 1]) + 1
            if a > self.num_nodes:
                raise ValueError(
                    f"splice would leave a gap: id {a} past column end "
                    f"{self.num_nodes}")
            emit_old(prev_end, a)
            seg = vals[seg_lo[si]:seg_hi[si]]
            idx = np.concatenate(
                [[0], np.flatnonzero(seg[1:] != seg[:-1]) + 1])
            res_s.append(a + idx)
            res_p.append(seg[idx])
            prev_end = b
        emit_old(prev_end, self.num_nodes)
        start = np.concatenate(res_s)
        pid = np.concatenate(res_p)
        keep = np.ones(start.shape[0], dtype=bool)
        keep[1:] = pid[1:] != pid[:-1]  # merge adjacent equal-pid runs
        out = ExtentRuns(start[keep], pid[keep], n_new,
                         int(n_blocks or self.n_blocks))
        if out.start.size and (out.start[0] != 0 or
                               np.any(np.diff(out.start) <= 0)):
            raise AssertionError("splice produced a non-tiling run set")
        return out


# ----------------------------------------------------------------- levels
@dataclasses.dataclass
class QuotientLevel:
    """In-RAM edge triples of one Q_j, canonical (src, elabel, dst)
    order.  `dst` is a raw level-(j-1) pid."""

    src: np.ndarray      # int32 [Eq]
    elabel: np.ndarray   # int32 [Eq]
    dst: np.ndarray      # int32 [Eq]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def _level_dir(root: str, j: int) -> str:
    return os.path.join(root, f"level_{j:02d}")


def _level_from_ooc(g: OocGraph, stats: Optional[IOStats]) -> QuotientLevel:
    if g.num_edges == 0:
        e = np.empty(0, np.int32)
        return QuotientLevel(e, e.copy(), e.copy())
    rec = np.concatenate(list(g.iter_edges_tst(stats)))
    return QuotientLevel(np.ascontiguousarray(rec["src"]),
                         np.ascontiguousarray(rec["elabel"]),
                         np.ascontiguousarray(rec["dst"]))


# ------------------------------------------------------------------ index
class QuotientIndex:
    """A loaded (or freshly materialized) quotient artifact: per-level
    edge triples, block labels, and extent runs, plus open `OocGraph`
    handles for in-place patching."""

    def __init__(self, root: str, *, k: int, mode: str, num_nodes: int,
                 counts: List[int], labels: List[np.ndarray],
                 runs: List[ExtentRuns], levels: Dict[int, QuotientLevel],
                 graphs: Dict[int, OocGraph], epoch: int = 0):
        self.root = root
        self.k = int(k)
        self.mode = mode
        self.num_nodes = int(num_nodes)
        self.counts = [int(c) for c in counts]      # id-space size per level
        self.labels = labels                        # int32 [counts[j]], j=0..k
        self.runs = runs                            # ExtentRuns, j=0..k
        self.levels = levels                        # QuotientLevel, j=1..k
        self.graphs = graphs                        # OocGraph, j=1..k
        self.epoch = int(epoch)

    # ------------------------------------------------------------------ IO
    def write_meta(self) -> None:
        """Persist labels + runs + meta and write the top manifest —
        the manifest write is the commit point (the level OocGraphs
        commit their own manifests on every mutation)."""
        man = Manifest(meta=dict(
            version=1, k=self.k, mode=self.mode, num_nodes=self.num_nodes,
            counts=self.counts, epoch=self.epoch))
        for j in range(self.k + 1):
            for name, arr in ((f"labels_{j}.npy", self.labels[j]),
                              (f"runs_start_{j}.npy", self.runs[j].start),
                              (f"runs_pid_{j}.npy", self.runs[j].pid)):
                aio_mod.atomic_save(os.path.join(self.root, name), arr)
                man.add_array(name, arr)
        man.write(self.root)

    @classmethod
    def load(cls, root: str, *, verify: bool = True,
             stats: Optional[IOStats] = None) -> "QuotientIndex":
        man = Manifest.load(root)
        meta = man.meta
        if meta.get("version") != 1:
            raise ChecksumError(
                f"unsupported quotient artifact version: {meta}")
        if verify:
            man.verify(root, stats=stats)
        k = int(meta["k"])
        counts = [int(c) for c in meta["counts"]]
        num_nodes = int(meta["num_nodes"])
        labels, runs = [], []
        for j in range(k + 1):
            labels.append(np.load(os.path.join(root, f"labels_{j}.npy")))
            runs.append(ExtentRuns(
                np.load(os.path.join(root, f"runs_start_{j}.npy")),
                np.load(os.path.join(root, f"runs_pid_{j}.npy")),
                num_nodes, counts[j]))
        levels, graphs = {}, {}
        for j in range(1, k + 1):
            g = OocGraph.load(_level_dir(root, j), verify=verify,
                              stats=stats)
            graphs[j] = g
            levels[j] = _level_from_ooc(g, stats)
        return cls(root, k=k, mode=meta["mode"], num_nodes=num_nodes,
                   counts=counts, labels=labels, runs=runs, levels=levels,
                   graphs=graphs, epoch=int(meta.get("epoch", 0)))

    def refresh_level(self, j: int,
                      stats: Optional[IOStats] = None) -> None:
        """Re-read level j's triples from its (just patched) OocGraph."""
        self.levels[j] = _level_from_ooc(self.graphs[j], stats)


# ----------------------------------------------------------- construction
def _pid_columns(pid_history, k: Optional[int] = None) -> List[np.ndarray]:
    """Normalize any pid-history shape to a list of per-level columns
    (arrays or memmaps): `BisimResult`, `OocBisimResult` (per-level
    .npy paths are memory-mapped, never fully loaded), a stacked
    [k+1, N] array, or a list of arrays/paths."""
    paths = getattr(pid_history, "pid_paths", None)
    if paths is not None:
        return [np.load(p, mmap_mode="r") for p in paths]
    arr = getattr(pid_history, "pids", pid_history)
    if isinstance(arr, np.ndarray):
        cols = [arr[j] for j in range(arr.shape[0])]
    else:
        cols = [np.load(c, mmap_mode="r") if isinstance(c, str) else c
                for c in arr]
    if k is not None and len(cols) != k + 1:
        raise ValueError(
            f"pid history has {len(cols)} levels, expected k+1={k + 1}")
    return cols


def _edge_chunks(graph, budget_rows: int, stats: Optional[IOStats]):
    """(src, elabel, dst) int64/int32 column chunks in E_tst order."""
    if isinstance(graph, OocGraph):
        for rec in graph.iter_edges_tst(stats):
            yield (rec["src"].astype(np.int64), rec["elabel"],
                   rec["dst"].astype(np.int64))
    else:
        for s in range(0, graph.num_edges, budget_rows):
            sl = slice(s, s + budget_rows)
            yield (graph.src[sl].astype(np.int64), graph.elabel[sl],
                   graph.dst[sl])


def _block_labels(graph, pid_cols, counts: List[int],
                  budget_rows: int, stats: Optional[IOStats]
                  ) -> List[np.ndarray]:
    """labels_j[p] = node label of any member of block p (uniform:
    every level refines pId_0); -1 marks a vacated block id."""
    out = [np.full(c, -1, dtype=np.int32) for c in counts]
    if isinstance(graph, OocGraph):
        chunks = graph.iter_nodes(stats)  # yields (base, label chunk)
    else:
        chunks = ((s, graph.node_labels[s:s + budget_rows])
                  for s in range(0, graph.num_nodes, budget_rows))
    for base, lab in chunks:
        ids = np.arange(base, base + lab.shape[0], dtype=np.int64)
        for j, col in enumerate(pid_cols):
            out[j][np.asarray(col[ids]).astype(np.int64)] = lab
    return out


def materialize_quotient(graph, pid_history, out_dir: str, *,
                         counts: Optional[List[int]] = None,
                         mode: str = "sorted",
                         chunk_rows: int = 1 << 16,
                         budget_rows: int = 1 << 16,
                         stats: Optional[IOStats] = None,
                         aio: Optional["aio_mod.AioConfig"] = None,
                         overwrite: bool = False) -> QuotientIndex:
    """Build and persist the full quotient artifact for a
    (`Graph` | `OocGraph`, pid history) pair.

    One sort(E) per level: stream E_tst, map to (pId_j(src), eLabel,
    pId_{j-1}(dst)) records, `external_sort` by that key, dedup
    adjacent records, persist as the level's `OocGraph`.  ``counts``
    optionally fixes each level's pid id-space size (a maintainer's
    `next_pid`); by default it is max(pid)+1 per level.
    """
    if os.path.exists(out_dir):
        if not overwrite:
            raise FileExistsError(
                f"quotient dir exists: {out_dir!r} (overwrite=False)")
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    pid_cols = _pid_columns(pid_history)
    k = len(pid_cols) - 1
    num_nodes = graph.num_nodes
    is_ooc = isinstance(graph, OocGraph)
    pid_stats = stats if is_ooc else None  # in-memory gathers are free

    with obs.span("quotient.materialize", k=k, nodes=num_nodes,
                  edges=graph.num_edges, io=stats):
        runs = []
        for j in range(k + 1):
            runs.append(ExtentRuns.from_column(
                pid_cols[j], num_nodes, 0, stats=pid_stats))
        eff_counts = [int(c) for c in counts] if counts is not None else [
            int(r.pid.max()) + 1 if r.pid.size else 0 for r in runs]
        if len(eff_counts) != k + 1:
            raise ValueError("counts must have k+1 entries")
        for j, r in enumerate(runs):
            if r.pid.size and r.pid.max() >= eff_counts[j]:
                raise ValueError(f"level-{j} pids exceed counts[{j}]")
            if eff_counts[j] > _PID_LIMIT:
                raise OverflowError(
                    f"level-{j} pid space exceeds int32; re-densify "
                    "(rebuild) before materializing")
            r.n_blocks = eff_counts[j]

        labels = _block_labels(graph, pid_cols, eff_counts, budget_rows,
                               pid_stats)

        levels: Dict[int, QuotientLevel] = {}
        graphs: Dict[int, OocGraph] = {}
        for j in range(1, k + 1):
            with obs.span("quotient.level", level=j):
                pj, pprev = pid_cols[j], pid_cols[j - 1]

                def _triples():
                    for src, el, dst in _edge_chunks(graph, budget_rows,
                                                     stats):
                        ps = np.asarray(pj[src]).astype(np.int64)
                        pt = np.asarray(pprev[dst]).astype(np.int64)
                        if pid_stats is not None:
                            pid_stats.count_scan(2 * src.shape[0],
                                                 16 * src.shape[0])
                        yield make_records(
                            {"ps": ps, "el": el.astype(np.int64),
                             "pt": pt})

                tmpdir = os.path.join(out_dir, f"tmp_sort_{j}")
                os.makedirs(tmpdir, exist_ok=True)
                outs, last = [], None
                for rec in external_sort(_triples(), ("ps", "el", "pt"),
                                         tmpdir, budget_rows=budget_rows,
                                         stats=stats, aio=aio,
                                         obs_attrs={"level": j}):
                    if rec.shape[0] == 0:
                        continue
                    keep = np.ones(rec.shape[0], dtype=bool)
                    neq = np.zeros(max(rec.shape[0] - 1, 0), dtype=bool)
                    for f in rec.dtype.names:
                        neq |= rec[f][1:] != rec[f][:-1]
                    keep[1:] = neq
                    if last is not None:
                        keep[0] = any(rec[0][f] != last[f]
                                      for f in rec.dtype.names)
                    last = rec[-1]
                    outs.append(rec[keep])
                shutil.rmtree(tmpdir)
                if outs:
                    cat = np.concatenate(outs)
                    ps = cat["ps"].astype(np.int32)
                    el = cat["el"].astype(np.int32)
                    pt = cat["pt"].astype(np.int32)
                else:
                    ps = el = pt = np.empty(0, np.int32)
                n_q = max(eff_counts[j], eff_counts[j - 1], 1)
                qg = Graph(np.full(n_q, -1, np.int32), ps, pt, el)
                graphs[j] = OocGraph.from_graph(
                    qg, _level_dir(out_dir, j), chunk_nodes=chunk_rows,
                    chunk_edges=chunk_rows, aio=aio)
                levels[j] = QuotientLevel(ps, el, pt)

        index = QuotientIndex(
            out_dir, k=k, mode=mode, num_nodes=num_nodes,
            counts=eff_counts, labels=labels, runs=runs, levels=levels,
            graphs=graphs, epoch=0)
        index.write_meta()
    return index
