"""Out-of-core maintenance backend: paper §4 over disk-resident tables.

`OocBackend` implements `core.maintenance.MaintenanceBackend` for graphs
that needed `build_bisim_oocore` in the first place: the N_t/E_t
tables stay chunked on disk (`OocGraph`), the pid history pId_0..pId_k
stays in the per-level ``.npy`` files the build wrote, and the signature
store S stays a `SpillableSigStore` per level (kept alive across updates
via the build's ``keep_stores=True``).

The access discipline honors the paper's I/O bounds per update batch:

  * graph mutations are the `OocGraph` table rewrites — insertion is a
    2-way emit-boundary merge through the shared `core.kway` core
    (`O(sort(|E_t|))`), deletion and compaction are filtered scans;
  * `frontier_signatures` *streams* the frontier's out-edges from one
    sequential E_tst scan, then resolves pId_{j-1}(tgt) by sorting the
    selected edges by target and merge-joining them against the pid file
    in windowed sequential reads — zero random pid accesses — before the
    same dedup + segment wrap-sum hash the in-memory engine uses
    (bit-identical signatures, so both backends agree up to renaming);
    with `enable_device()` the gathered batch is folded on the
    backend's ``device`` instead (`core.device_maint.frontier_fold`, the
    Hopper `sig_fold` kernel on a CUDA tensor) — the scan, join and
    IOStats charges are byte-identical, only the hash + segment-sum
    moves off-host; the store resolve stays on the spillable host store
    (S must be allowed to outgrow RAM here), so device and host
    propagation produce bit-identical pid files and exactly equal
    counters;
  * `parents_of` is one sequential E_tts scan;
  * pid reads/writes for a (sorted) frontier are windowed sequential
    passes over the level's file.

Every pass charges `IOStats` (`self.io`): per update batch the counters
grow by one `sort(|E_t|)` (table maintenance) plus k sequential E_t/N_t
scans and k frontier-sized sorts — within the paper's
`O(k·sort(|E_t|) + k·sort(|N_t|))` maintenance bound, and linear in k
(asserted by tests).

Durability (``wal=True``): the backend owns a group-commit
`exmem.durability.WriteAheadLog` under ``workdir/wal`` — every logical
update batch the maintainer applies is appended (via `StreamingWriter`)
*before* the table/pid mutations start, and becomes durable at the
fsync'd commit line (every ``wal_group`` appends).  `snapshot()`
persists the whole maintained state — graph tables, pid files, flushed
store runs, tombstones, next-pid counters — as a manifest-committed
directory under ``workdir/snapshot`` (atomic dir swap; the manifest is
the commit record), pruning WAL records the snapshot absorbs.
`OocBackend.restore(workdir)` reopens it with full checksum
verification (a corrupted artifact raises `ChecksumError`, never a
silently wrong partition) and `BisimMaintainer.restore` then redo-
replays the committed WAL tail — the crash-recovery protocol the fuzz
harness kills at every injected fault point.  Snapshot + recovery I/O
is O(k·sort/scan of the tables), charged to `self.io`.

The port of `repro.exmem.maintenance`, charge for charge: every scan,
sort and window of the reference runs here too, at every level, so the
`IOStats` dicts are equal.  The backend's builds (the first one, the
§4.2 rebuild and Change-k upward) fold every chunk on ``device`` through
the Hopper `chunk_sig_fold` kernel.  What does not carry over: the
backend takes an explicit ``device`` (the card unless ``cpu`` is asked,
`repro_torch.resolve_device`), and a failure of its device fold raises
in the maintainer instead of degrading to the host path.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Tuple, Union

import numpy as np

from .. import resolve_device
from ..core import hashes_np
from ..core.integrity import ChecksumError
from ..core.maintenance import MaintenanceBackend
from ..core.sig_store import SpillableSigStore
from ..graph.storage import Graph
from ..obs import tracer as obs

from .aio import AioConfig, Pipeline, atomic_save
from .build import build_bisim_oocore
from .durability import (Manifest, WriteAheadLog, atomic_write_json,
                         commit_dir_swap, read_json)
from .runs import IOStats
from .tables import TST_DTYPE, OocGraph


class OocBackend(MaintenanceBackend):
    """Disk-resident `MaintenanceBackend` over `OocGraph` tables.

    Accepts an in-memory `Graph` (spilled into the workdir) or an
    `OocGraph` (copied into the workdir — maintenance mutates its
    tables, the caller's directory stays intact).  `workdir=None` uses a
    tempdir that `close()` removes.  ``device`` is where the builds and,
    with `enable_device()`, the frontier folds run: the card unless
    ``"cpu"`` is asked for (it raises without one).
    """

    def __init__(self, graph: Union[Graph, OocGraph], *,
                 workdir: Optional[str] = None,
                 chunk_edges: int = 1 << 16,
                 chunk_nodes: Optional[int] = None,
                 spill_threshold: int = 1 << 20,
                 io_threads: int = 1, prefetch_depth: int = 2,
                 wal: bool = False, wal_group: int = 1,
                 wal_async: bool = False, device=None):
        self.device = resolve_device(device)
        self.io = IOStats()
        # one async pipeline per backend: the builds it runs, its table
        # scans, and its pid-file rewrites all share the executor and the
        # overlap stats (io_threads=0 => fully synchronous)
        self.aio = AioConfig(io_threads=io_threads,
                             prefetch_depth=prefetch_depth)
        self._owns_workdir = workdir is None
        if workdir is None:
            workdir = tempfile.mkdtemp(prefix="ooc-maint-")
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        graph_dir = os.path.join(workdir, "graph")
        if isinstance(graph, OocGraph):
            if os.path.abspath(graph.root) != os.path.abspath(graph_dir):
                shutil.rmtree(graph_dir, ignore_errors=True)
                graph.save(graph_dir)
            self.ooc = OocGraph(graph_dir, aio=self.aio)
        else:
            self.ooc = graph.to_ooc(
                graph_dir, chunk_nodes=chunk_nodes or chunk_edges,
                chunk_edges=chunk_edges)
            self.ooc.aio = self.aio
        self.spill_threshold = spill_threshold
        self.stores: Optional[list] = None
        self.next_pid: Optional[list] = None
        self.pid_paths: list = []
        self._pid_mms: dict = {}
        self._build_dir: Optional[str] = None
        self._build_seq = 0
        self._device = False
        self._closed = False
        self._wal = (WriteAheadLog(os.path.join(workdir, "wal"),
                                   group=wal_group, aio=self.aio,
                                   async_commits=wal_async)
                     if wal else None)

    def wal_enable_async(self, enabled: bool = True) -> None:
        """Flip the WAL's group-commit fsync rounds onto the shared aio
        executor (or back).  Usable after `restore`, which reopens the
        WAL synchronous by default."""
        if self._wal is not None:
            if not enabled:
                self._wal.drain()
            self._wal.async_commits = bool(enabled)

    # ----------------------------------------------------- device capability
    def enable_device(self) -> bool:
        self._device = True
        return True

    # ------------------------------------------------------------ geometry
    @property
    def num_nodes(self) -> int:
        return self.ooc.num_nodes

    @property
    def num_edges(self) -> int:
        return self.ooc.num_edges

    @property
    def graph(self) -> Graph:
        """Materialized in-memory copy (tests / small graphs only)."""
        return self.ooc.to_memory()

    # ------------------------------------------------------------- (re)build
    def build(self, k: int, mode: str, *, result=None) -> None:
        if result is not None:
            raise ValueError(
                "OocBackend builds its own state; `result` injection is "
                "an InMemoryBackend feature")
        self._dispose_build()
        bdir = os.path.join(self.workdir, f"build_{self._build_seq:03d}")
        self._build_seq += 1
        res = build_bisim_oocore(
            self.ooc, k, mode=mode, early_stop=False, workdir=bdir,
            spill_threshold=self.spill_threshold, keep_stores=True,
            stats=self.io, aio=self.aio, device=self.device)
        self.pid_paths = list(res.pid_paths)
        self.stores = res.stores
        self.next_pid = list(res.next_pids)
        self._build_dir = bdir

    def _dispose_build(self) -> None:
        if self.stores:
            for s in self.stores:
                s.close()
        self.stores = None
        self._pid_mms.clear()
        if self._build_dir is not None:
            shutil.rmtree(self._build_dir, ignore_errors=True)
            self._build_dir = None

    def close(self) -> None:
        """Release stores, pid files, the WAL, the pipeline executor, and
        (if owned) the workdir.  Idempotent, and safe mid-teardown after
        an injected crash: every stage runs even if an earlier one threw,
        so no aio worker threads or spill files outlive the backend.

        Ordering contract: the WAL closes (draining any in-flight async
        commit round and committing pending records) strictly before the
        aio executor shuts down — a stop mid-group must never abandon a
        commit round on a dying pool or publish a partial commit line."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._wal is not None:
                self._wal.close()  # drains async rounds + commits pending
        finally:
            self._dispose_build()
            self.aio.close()
            if self._owns_workdir:
                shutil.rmtree(self.workdir, ignore_errors=True)

    # ------------------------------------------------------------ durability
    @property
    def wal_supported(self) -> bool:
        return self._wal is not None

    def wal_append(self, op: str, arrays: dict) -> int:
        lsn = self._wal.append(op, arrays)
        self.io.bump("runs_written")
        return lsn

    def wal_flush(self) -> None:
        if self._wal is not None:
            self._wal.commit()

    def wal_replay_records(self, after_lsn: int = 0):
        if self._wal is None:
            return
        for lsn, op, arrays in self._wal.replay(after_lsn):
            nbytes = sum(int(a.nbytes) for a in arrays.values())
            self.io.count_scan(max(len(arrays), 1), nbytes)
            yield lsn, op, arrays

    def snapshot(self, state: dict) -> None:
        """Persist graph tables, pid history, flushed store runs, and the
        maintainer `state` as a manifest-committed snapshot directory.
        The write order is the commit protocol: all bulk artifacts, then
        ``state.json``, then the manifest (the commit record), then the
        atomic dir swap into ``workdir/snapshot`` — a crash anywhere
        leaves either the previous snapshot or a tmp dir a later
        snapshot overwrites, never a half-snapshot that verifies."""
        if self.stores is None:
            raise RuntimeError("snapshot() before build()")
        with obs.span("wal.snapshot", levels=len(self.pid_paths),
                      io=self.io):
            self._snapshot_inner(state)

    def _snapshot_inner(self, state: dict) -> None:
        tmp = os.path.join(self.workdir, "snapshot.aio-tmpdir")
        live = os.path.join(self.workdir, "snapshot")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        man = Manifest()
        # graph tables: copied whole; their own chunk manifest (already
        # inside the directory) re-verifies them at restore
        self.ooc.save(os.path.join(tmp, "graph"))
        self.io.count_scan(self.ooc.num_nodes + 2 * self.ooc.num_edges,
                           self.ooc.num_nodes * 4
                           + 2 * self.ooc.num_edges * 12)
        # pid files: one sequential read+write per level, checksummed
        # from the bytes in hand
        for j, path in enumerate(self.pid_paths):
            arr = np.load(path)
            rel = f"pid_{j:03d}.npy"
            atomic_save(os.path.join(tmp, rel), arr)
            man.add_array(rel, arr)
            self.io.count_scan(arr.shape[0], arr.nbytes * 2)
        # stores: flush the resident runs so the on-disk files are the
        # whole store, then hard-copy them with their recorded checksums
        store_states = []
        for j, s in enumerate(self.stores):
            s.flush()
            st = s.state()
            store_states.append(st)
            sdir = os.path.join(tmp, "stores", f"lvl_{j:03d}")
            os.makedirs(sdir, exist_ok=True)
            for kp_rel, pp_rel, ln in st["runs"]:
                for rel, nbytes in ((kp_rel, ln * 8), (pp_rel, ln * 8)):
                    shutil.copy2(os.path.join(s.spill_dir, rel),
                                 os.path.join(sdir, rel))
                    man.add_checksum(f"stores/lvl_{j:03d}/{rel}", ln,
                                     st["sums"][rel])
                    self.io.count_sort(ln, nbytes)
        tomb = np.asarray(state["tombstone"], dtype=bool)
        atomic_save(os.path.join(tmp, "tombstone.npy"), tomb)
        man.add_array("tombstone.npy", tomb)
        wal_lsn = self._wal.committed_lsn if self._wal is not None else 0
        st_json = {k: v for k, v in state.items() if k != "tombstone"}
        st_json.update(
            next_pid=[int(x) for x in self.next_pid],
            levels=len(self.pid_paths),
            spill_threshold=int(self.spill_threshold),
            wal=self._wal is not None, wal_lsn=int(wal_lsn),
            wal_group=(self._wal.group if self._wal is not None else 1),
            stores=store_states)
        atomic_write_json(os.path.join(tmp, "state.json"), st_json)
        man.write(tmp)  # the snapshot's commit record
        commit_dir_swap(live, tmp)
        if self._wal is not None:
            # records the snapshot absorbed are never replayed again
            self._wal.truncate(wal_lsn)

    @classmethod
    def restore(cls, workdir: str, *,
                io_threads: int = 1, prefetch_depth: int = 2,
                device=None) -> Tuple["OocBackend", dict]:
        """Reopen the last committed snapshot under ``workdir``.

        Every artifact is checksum-verified as it is adopted (graph
        chunks via the table manifest, pid files and store runs via the
        snapshot manifest — runs lazily at first probe), so corruption
        raises `ChecksumError` here rather than surfacing as a wrong
        partition.  The pre-crash live tables and build dirs are
        discarded: recovery is snapshot + committed WAL redo, nothing
        else.  Returns ``(backend, state)`` for
        `BisimMaintainer.restore`, which performs the WAL replay.
        ``device`` is the restored backend's, as in the constructor."""
        device = resolve_device(device)
        with obs.span("wal.restore", workdir=os.path.basename(workdir)):
            return cls._restore_inner(workdir, io_threads=io_threads,
                                      prefetch_depth=prefetch_depth,
                                      device=device)

    @classmethod
    def _restore_inner(cls, workdir: str, *, io_threads: int,
                       prefetch_depth: int,
                       device) -> Tuple["OocBackend", dict]:
        snap = os.path.join(workdir, "snapshot")
        if not os.path.isdir(snap):
            raise ChecksumError(f"no committed snapshot under {workdir!r}")
        man = Manifest.load(snap)
        st = read_json(os.path.join(snap, "state.json"))
        self = object.__new__(cls)
        self.device = device
        self.io = IOStats()
        self.aio = AioConfig(io_threads=io_threads,
                             prefetch_depth=prefetch_depth)
        self._owns_workdir = False
        self.workdir = workdir
        self.spill_threshold = int(st.get("spill_threshold", 1 << 20))
        self._pid_mms = {}
        self._build_seq = 0
        self._device = False
        self._closed = False
        # drop the killed process's live state: half-mutated tables,
        # partial builds, unpublished writer temps
        for name in os.listdir(workdir):
            p = os.path.join(workdir, name)
            if name == "graph" or name.startswith("build_") \
                    or name == "restored":
                shutil.rmtree(p, ignore_errors=True)
            elif name.endswith(".aio-tmp") or name == "snapshot.aio-tmpdir":
                (shutil.rmtree(p, ignore_errors=True) if os.path.isdir(p)
                 else os.remove(p))
        graph_dir = os.path.join(workdir, "graph")
        shutil.copytree(os.path.join(snap, "graph"), graph_dir)
        self.ooc = OocGraph.load(graph_dir, verify=True, stats=self.io)
        self.ooc.aio = self.aio
        # pid files + store runs + tombstone: verified while copying
        bdir = os.path.join(workdir, "restored")
        man.verify_copy(snap, bdir, stats=self.io)
        self._build_dir = bdir
        levels = int(st["levels"])
        self.pid_paths = [os.path.join(bdir, f"pid_{j:03d}.npy")
                          for j in range(levels)]
        self.stores = []
        for j, sst in enumerate(st["stores"]):
            sdir = os.path.join(bdir, "stores", f"lvl_{j:03d}")
            os.makedirs(sdir, exist_ok=True)
            s = SpillableSigStore(
                spill_threshold=self.spill_threshold, spill_dir=sdir,
                io=self.io, aio=self.aio)
            s.adopt_state(sst)
            self.stores.append(s)
        self.next_pid = [int(x) for x in st["next_pid"]]
        # start_lsn floors the numbering past the snapshot even when the
        # snapshot truncated the whole log (empty commits.log)
        self._wal = (WriteAheadLog(os.path.join(workdir, "wal"),
                                   group=int(st.get("wal_group", 1)),
                                   aio=self.aio,
                                   start_lsn=int(st.get("wal_lsn", 0)))
                     if st.get("wal", False) else None)
        state = dict(
            k=int(st["k"]), mode=st["mode"],
            rebuild_threshold=float(st["rebuild_threshold"]),
            wal=bool(st.get("wal", False)),
            wal_lsn=int(st.get("wal_lsn", 0)),
            tombstone=np.load(os.path.join(bdir, "tombstone.npy")))
        return self, state

    # ---------------------------------------------------------- pid history
    def _pid(self, j: int) -> np.ndarray:
        mm = self._pid_mms.get(j)
        if mm is None:
            mm = self._pid_mms[j] = np.load(self.pid_paths[j],
                                            mmap_mode="r+")
        return mm

    def _gather_sorted(self, mm: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """pid values for ascending-sorted ids: windowed sequential reads
        of the pid file (the sorted merge join against pId_j — no random
        accesses; the file pointer only moves forward)."""
        out = np.empty(ids.shape[0], np.int64)
        win = self.ooc.chunk_nodes
        pos = 0
        while pos < ids.shape[0]:
            base = int(ids[pos])
            cut = int(np.searchsorted(ids, base + win, side="left"))
            window = np.asarray(mm[base:base + win])
            out[pos:cut] = window[ids[pos:cut] - base]
            self.io.count_scan(window.shape[0], window.nbytes)
            pos = cut
        return out

    def pid_column(self, j: int) -> np.ndarray:
        mm = self._pid(j)
        self.io.count_scan(mm.shape[0], mm.nbytes)
        return np.array(mm).astype(np.int64)

    def pid_at(self, j: int, nodes: np.ndarray) -> np.ndarray:
        return self._gather_sorted(self._pid(j),
                                   np.asarray(nodes, dtype=np.int64))

    def set_pid_at(self, j: int, nodes: np.ndarray,
                   values: np.ndarray) -> None:
        mm = self._pid(j)
        mm[np.asarray(nodes, dtype=np.int64)] = \
            np.asarray(values).astype(np.int32)
        mm.flush()
        self.io.count_sort(len(nodes), len(nodes) * 4)  # pid-file merge

    def append_pid_rows(self, j: int, values: np.ndarray) -> None:
        """Grow pId_j by `values` rows: copy + append streamed through a
        `Pipeline` into a StreamingWriter (prefetched reads, double-
        buffered writes, atomic swap of the pid file)."""
        values = np.asarray(values).astype(np.int32)
        path = self.pid_paths[j]
        old = np.load(path, mmap_mode="r")
        n = old.shape[0]
        win = self.ooc.chunk_nodes

        def _chunks():
            for s in range(0, n, win):
                yield np.array(old[s:s + win])
            yield values

        writer = self.aio.writer(path, np.int32, n + values.shape[0])
        try:
            Pipeline(_chunks(), writer=writer, aio=self.aio).run()
        except BaseException:
            writer.abort()
            raise
        writer.close()
        del old
        self._pid_mms.pop(j, None)
        self.io.count_scan(n, n * 4)
        self.io.count_sort(values.shape[0], values.nbytes)

    # ---------------------------------------------------------------- store
    def resolve(self, j: int, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys)
        out, self.next_pid[j] = self.stores[j].get_or_assign(
            keys, self.next_pid[j])
        if self.next_pid[j] > np.iinfo(np.int32).max:
            # the pid files keep the build's int32 format; minted pids
            # grow monotonically, so fail loudly instead of wrapping
            # (the in-memory backend's int64 columns have no such limit)
            raise OverflowError(
                f"level-{j} pid space exceeded int32; rebuild to "
                f"re-densify pids")
        self.io.count_sort(keys.shape[0], keys.shape[0] * 8)  # ranking via S
        return out

    # -------------------------------------------------------------- gathers
    def _frontier_out_edges(self, frontier: np.ndarray) -> np.ndarray:
        """One sequential E_tst scan selecting the frontier's out-edges;
        the concatenated selection inherits the global (src, elabel, dst)
        order."""
        sel = []
        for chunk in self.ooc.iter_edges_tst(self.io):
            cs = chunk["src"]
            pos = np.minimum(np.searchsorted(frontier, cs),
                             frontier.shape[0] - 1)
            hit = frontier[pos] == cs
            if hit.any():
                sel.append(chunk[hit])
        return (np.concatenate(sel) if sel
                else np.empty(0, TST_DTYPE))

    def _gather_frontier(self, j: int, frontier: np.ndarray):
        """Shared host/device gather: stream-select the frontier's
        out-edges, merge-join pId_{j-1}(tgt) against the pid file, and
        hand back flat (pid0, seg, elabel, pid_tgt) fold inputs.  Both
        folds charge identical IOStats — the device path changes where
        the hash runs, never what the disk does."""
        edges = self._frontier_out_edges(frontier)
        # pId_{j-1}(tgt): sort the selection by target, merge-join it
        # against the pid file's windowed sequential stream, scatter back
        order = np.argsort(edges["dst"], kind="stable")
        self.io.count_sort(edges.shape[0], edges.nbytes)
        pid_tgt = np.empty(edges.shape[0], np.int64)
        pid_tgt[order] = self._gather_sorted(
            self._pid(j - 1), edges["dst"][order].astype(np.int64))
        seg = np.searchsorted(frontier, edges["src"].astype(np.int64))
        p0 = self._gather_sorted(self._pid(0), frontier)
        self.io.count_sort(edges.shape[0], edges.nbytes)
        return p0, seg, edges["elabel"], pid_tgt

    def frontier_signatures(self, j: int, frontier: np.ndarray, *,
                            dedup: bool = True):
        frontier = np.asarray(frontier, dtype=np.int64)
        p0, seg, lab, pid_tgt = self._gather_frontier(j, frontier)
        # the (src, elabel, pid) re-sort + dedup + segment wrap-sum inside
        # signatures_from_edges is the in-memory engine's — bit-identical
        return hashes_np.signatures_from_edges(
            p0, seg, lab, pid_tgt, frontier.shape[0], dedup=dedup)

    def frontier_signatures_device(self, j: int, frontier: np.ndarray, *,
                                   dedup: bool = True):
        if not self._device:
            return None
        from ..core.device_maint import frontier_fold
        frontier = np.asarray(frontier, dtype=np.int64)
        p0, seg, lab, pid_tgt = self._gather_frontier(j, frontier)
        # no batch cache: every level re-runs the reference's E_tst scan
        # and pid joins, so the counters describe I/O that really ran
        return frontier_fold(p0, seg, lab, pid_tgt, frontier.shape[0],
                             device=self.device, dedup=dedup)

    def parents_of(self, nodes: np.ndarray) -> np.ndarray:
        nodes = np.asarray(nodes, dtype=np.int64)
        parents = []
        for chunk in self.ooc.iter_edges_tts(self.io):
            cd = chunk["dst"]
            pos = np.minimum(np.searchsorted(nodes, cd),
                             nodes.shape[0] - 1)
            hit = nodes[pos] == cd
            if hit.any():
                parents.append(chunk["src"][hit])
        if not parents:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(parents)).astype(np.int64)

    def incident_edges(self, nid: int):
        rows = []
        for chunk in self.ooc.iter_edges_tst(self.io):
            m = (chunk["src"] == nid) | (chunk["dst"] == nid)
            if m.any():
                rows.append(chunk[m])
        cat = (np.concatenate(rows) if rows else np.empty(0, TST_DTYPE))
        return cat["src"], cat["elabel"], cat["dst"]

    def out_edges_of(self, nodes: np.ndarray):
        # one E_tst scan instead of the ABC's per-node incident_edges loop
        ids = np.unique(np.asarray(nodes, dtype=np.int64))
        if ids.size == 0:
            e = np.empty(0, np.int32)
            return e, e.copy(), e.copy()
        edges = self._frontier_out_edges(ids)
        return edges["src"], edges["elabel"], edges["dst"]

    def node_labels_of(self, nodes: np.ndarray) -> np.ndarray:
        ids = np.asarray(nodes, dtype=np.int64)
        if ids.size == 0:
            return np.empty(0, dtype=np.int32)
        order = np.argsort(ids, kind="stable")
        srt = ids[order]
        out = np.empty(ids.shape[0], np.int32)
        for base, labels in self.ooc.iter_nodes(self.io):
            lo = np.searchsorted(srt, base)
            hi = np.searchsorted(srt, base + labels.shape[0])
            if hi > lo:
                out[order[lo:hi]] = labels[srt[lo:hi] - base]
        return out

    # ------------------------------------------------------------ mutations
    def add_node_rows(self, labels: np.ndarray) -> int:
        return self.ooc.append_nodes(labels, stats=self.io)

    def add_edge_rows(self, src, elabel, dst) -> None:
        self.ooc.insert_edges(src, elabel, dst, stats=self.io)

    def remove_edge_rows(self, src, elabel, dst) -> None:
        self.ooc.delete_edges(src, elabel, dst, stats=self.io)

    def compact(self, keep: np.ndarray, remap: np.ndarray) -> None:
        self.ooc.compact_rows(keep, remap, stats=self.io)
        n_new = int(np.count_nonzero(keep))
        win = self.ooc.chunk_nodes
        for j, path in enumerate(self.pid_paths):
            old = np.load(path, mmap_mode="r")

            def _chunks(old=old):
                for s in range(0, old.shape[0], win):
                    yield s, np.array(old[s:s + win])

            def _filter(item):
                s, chunk = item
                self.io.count_scan(chunk.shape[0], chunk.nbytes)
                return chunk[keep[s:s + chunk.shape[0]]]

            writer = self.aio.writer(path, np.int32, n_new)
            try:
                Pipeline(_chunks(), transform=_filter, writer=writer,
                         aio=self.aio).run()
            except BaseException:
                writer.abort()
                raise
            writer.close()
            del old
            self._pid_mms.pop(j, None)

    # -------------------------------------------------------------- change k
    def truncate_k(self, new_k: int) -> None:
        for s in self.stores[new_k + 1:]:
            s.close()
        self.stores = self.stores[: new_k + 1]
        self.next_pid = self.next_pid[: new_k + 1]
        for j in range(new_k + 1, len(self.pid_paths)):
            self._pid_mms.pop(j, None)
            os.remove(self.pid_paths[j])
        self.pid_paths = self.pid_paths[: new_k + 1]

    def extend_k(self, new_k: int, mode: str) -> None:
        # Out-of-core Change-k (increase) rebuilds: running extra
        # iterations on top of pId_k needs the same join/fold pipeline a
        # build runs anyway, and a rebuild yields the identical partition.
        self.build(new_k, mode)
