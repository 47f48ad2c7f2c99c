"""Maintenance of an existing k-bisimulation partition (paper §4, Alg. 2-4).

The port of `repro.core.maintenance`, split as the reference splits it:

  * `BisimMaintainer` owns what Algorithms 2-4 say: per-level frontier
    evolution (the STXXL priority queue of (iteration, nId) pairs becomes
    frontier[j], level by level; "propagate changes to pQueue", line 20 of
    Alg. 4, becomes frontier[j+1] |= parents(changed)), tombstones for
    DELETE_NODE, `compact`, the §4.2 switch back to Build_Bisim
    (`rebuild_threshold`) and Change-k.

  * `MaintenanceBackend` is everything storage: the pid history, the
    frontier gathers, the signature stores and the graph mutations.
    `InMemoryBackend` below keeps the graph, CSR indexes and pid history
    on the host and, with device propagation, the per-level stores on
    the card (`core.device_maint.DeviceSigStore`).  The out-of-core
    backend, `repro_torch.exmem.OocBackend`, keeps all of it on disk and
    owns the write-ahead log.

  * Durability (``wal=True``, on a backend with a write-ahead log): every
    outermost logical update is appended to the log before it mutates
    anything (the redo rule); `snapshot` commits the log and persists the
    backend's state; `restore` reopens a backend's snapshot and replays
    the committed records past it through these same update methods.

Signature modes: set semantics (`sorted` / `dedup_hash`, which hash
identically here) and `multiset`, which skips the (eLabel, pId) dedup as
construction does.

Device propagation (``device_propagation=True``, the default, on the
maintainer's ``device``): the frontier signature fold runs on the device
(through the Hopper `sig_fold` kernel on a CUDA tensor) and, with the
stores mirrored there, so do the S_j probe, the first-occurrence mint and
the merge-insert.  Frontier bookkeeping, parent gathers and graph
mutations stay on the host.  ``device_propagation=False`` is the numpy
host path (`hashes_np` + `SigStore`).  The two give bit-identical pid
histories, next_pid sequences, reports and stores.

What does not carry over from the reference: a failure on the device
path raises.  The reference degrades such a failure to the host path
with a warning, and lets a backend without the device capability keep
the host path silently; the port does neither, so a run that asked for
the device either ran there or stopped.
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph.storage import Graph
from ..obs import tracer as obs
from . import hashes_np
from .faults import fault_point
from .partition import BisimResult, bisim_step, build_bisim
from .sig_store import SigStore, fuse_key, label_key


@dataclasses.dataclass
class MaintenanceReport:
    """Per-update statistics (the quantities of paper Figs. 7-8).

    The per-level lists always have exactly k entries — levels the
    propagation never reached (empty frontier, or the §4.2 rebuild
    heuristic firing mid-loop) hold zeros.  ``device`` (the reference's
    key) says whether device propagation was taken.
    """
    nodes_checked: list          # per level j=1..k
    nodes_changed: list          # per level
    partitions_touched: list     # per level
    rebuilt: bool = False
    level_seconds: list = dataclasses.field(default_factory=list)
    device: bool = False         # device propagation path taken

    def as_dict(self) -> dict:
        """Uniform stats surface (same keys as the reference's)."""
        return {
            "nodes_checked": [int(x) for x in self.nodes_checked],
            "nodes_changed": [int(x) for x in self.nodes_changed],
            "partitions_touched": [int(x) for x in
                                   self.partitions_touched],
            "rebuilt": bool(self.rebuilt),
            "level_seconds": [float(x) for x in self.level_seconds],
            "device": bool(self.device),
        }

    def merge(self, other) -> "MaintenanceReport":
        """Fold another report (or its `as_dict()`) into this one, in
        place: per-level lists add elementwise (padded to the longer k),
        `rebuilt` ORs, `device` ANDs."""
        d = other.as_dict() if hasattr(other, "as_dict") else dict(other)

        def _add(mine: list, theirs: list) -> list:
            out = [0] * max(len(mine), len(theirs))
            for i, v in enumerate(mine):
                out[i] += v
            for i, v in enumerate(theirs):
                out[i] += v
            return out

        self.nodes_checked = _add(self.nodes_checked,
                                  d.get("nodes_checked", []))
        self.nodes_changed = _add(self.nodes_changed,
                                  d.get("nodes_changed", []))
        self.partitions_touched = _add(self.partitions_touched,
                                       d.get("partitions_touched", []))
        self.level_seconds = _add(self.level_seconds,
                                  d.get("level_seconds", []))
        self.rebuilt = bool(self.rebuilt or d.get("rebuilt", False))
        self.device = bool(self.device and d.get("device", False))
        return self


# the CSR frontier gather is shared with the batch signature path
_csr_gather = hashes_np.csr_gather


class MaintenanceBackend(abc.ABC):
    """Storage contract between `BisimMaintainer` and its state.

    A backend owns the graph tables (mutated by `add_node_rows` /
    `add_edge_rows` / `remove_edge_rows` / `compact`), the pid history
    (`pid_at` / `set_pid_at` / `pid_column` / `append_pid_rows`), one
    signature store S_j per level (level 0 keyed by node label, consulted
    through `resolve`) and the gathers (`frontier_signatures`,
    `parents_of`, `incident_edges`).

    Every ``nodes`` argument is a sorted, deduplicated int64 id array.
    Mutators validate before mutating: a rejected update leaves the
    backend untouched.  After `build()` a backend exposes ``graph``,
    ``stores``, ``next_pid`` and ``device`` (a torch device); one that
    holds its pid history as host arrays may expose ``pids`` too.
    """

    graph: Graph
    stores: list
    next_pid: list
    device: torch.device

    # ------------------------------------------------------------ geometry
    @property
    @abc.abstractmethod
    def num_nodes(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_edges(self) -> int: ...

    # ------------------------------------------------------------- (re)build
    @abc.abstractmethod
    def build(self, k: int, mode: str, *,
              result: Optional[BisimResult] = None) -> None:
        """Full Build_Bisim of the current graph: k+1 pid levels + stores.
        ``result`` optionally injects a `with_store=True` build."""

    # ---------------------------------------------------------- pid history
    @abc.abstractmethod
    def pid_column(self, j: int) -> np.ndarray:
        """The full pId_j column (int64 [N])."""

    @abc.abstractmethod
    def pid_at(self, j: int, nodes: np.ndarray) -> np.ndarray: ...

    @abc.abstractmethod
    def set_pid_at(self, j: int, nodes: np.ndarray,
                   values: np.ndarray) -> None: ...

    @abc.abstractmethod
    def append_pid_rows(self, j: int, values: np.ndarray) -> None: ...

    # ---------------------------------------------------------------- store
    @abc.abstractmethod
    def resolve(self, j: int, keys: np.ndarray) -> np.ndarray:
        """Bulk get-or-assign against S_j (Alg. 4 lines 13-17): fused
        signature keys to pids, minting dense fresh pids for novel keys
        in first-occurrence order."""

    # ---------------------------------------------------- device capability
    def enable_device(self) -> bool:
        """Opt into device propagation.  False: the backend has none, and
        a maintainer that asked for it raises."""
        return False

    def frontier_signatures_device(self, j: int, frontier: np.ndarray, *,
                                   dedup: bool = True):
        """Device sibling of `frontier_signatures`: (hi, lo) device
        tensors, or None when the capability is absent."""
        return None

    def resolve_pairs(self, j: int, hi, lo, count: int) -> np.ndarray:
        """`resolve` over (hi, lo) hash lanes (the first `count` are
        real).  Default: fuse on the host and resolve there."""
        obs.event("maint.sync", what="fold_pairs", keys=count)
        hi, lo = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                  for x in (hi, lo))
        return self.resolve(j, fuse_key(hi[:count], lo[:count]))

    def propagate_level_device(self, j: int, frontier: np.ndarray, *,
                               dedup: bool = True):
        """One device level: fold + resolve.  None when the capability
        is absent."""
        pair = self.frontier_signatures_device(j, frontier, dedup=dedup)
        if pair is None:
            return None
        return self.resolve_pairs(j, pair[0], pair[1], frontier.size)

    def propagate_level_resident(self, j: int, frontier: np.ndarray, *,
                                 dedup: bool = True):
        """The fused device level (fold + probe + mint + changed mask)
        against a store on the device: ``(pj int64 [f] | None, changed
        bool [f] | None, n_changed)``, the arrays None iff nothing
        changed.  None when the stores are not on the device (the
        maintainer then takes `propagate_level_device`)."""
        return None

    def propagate_levels_resident(self, frontier: np.ndarray, *,
                                  dedup: bool = True):
        """ALL k levels while nothing changes (the fused k-loop): None
        when the stores are not on the device, else ``(nclean, dirty)``;
        see `device_maint.resident_levels_resolve`."""
        return None

    # -------------------------------------------------------------- gathers
    @abc.abstractmethod
    def frontier_signatures(self, j: int, frontier: np.ndarray, *,
                            dedup: bool = True):
        """(hi, lo) u32 sig_j hash pairs of `frontier` from its out-edges'
        (eLabel, pId_{j-1}(tgt)) pairs and pId_0 — bit-identical to what
        construction stored in S_j."""

    @abc.abstractmethod
    def parents_of(self, nodes: np.ndarray) -> np.ndarray:
        """Sorted unique in-edge sources of `nodes` (uses E_tts)."""

    @abc.abstractmethod
    def incident_edges(self, nid: int):
        """(src, elabel, dst) arrays of every edge touching node `nid`."""

    # ------------------------------------------------------------ mutations
    @abc.abstractmethod
    def add_node_rows(self, labels: np.ndarray) -> int:
        """Append isolated nodes to N_t; returns the first new node id."""

    @abc.abstractmethod
    def add_edge_rows(self, src, elabel, dst) -> None: ...

    @abc.abstractmethod
    def remove_edge_rows(self, src, elabel, dst) -> None: ...

    @abc.abstractmethod
    def compact(self, keep: np.ndarray, remap: np.ndarray) -> None:
        """Drop the rows where ~keep from N_t, E_t and every pid level,
        remapping edge endpoints with the (monotone) `remap`."""

    # -------------------------------------------------------------- change k
    @abc.abstractmethod
    def truncate_k(self, new_k: int) -> None:
        """Slice pid history and stores down to levels 0..new_k."""

    @abc.abstractmethod
    def extend_k(self, new_k: int, mode: str) -> None:
        """Grow to new_k levels (extra Build_Bisim iterations on top of
        the stored state)."""

    # ------------------------------------------------------------ durability
    # A durable backend (`exmem.OocBackend` with its write-ahead log)
    # overrides these; the defaults describe a volatile backend with
    # nothing to log or restore.
    wal_supported: bool = False

    def wal_append(self, op: str, arrays: dict) -> int:
        """Append one logical update to the write-ahead log."""
        raise NotImplementedError("backend has no write-ahead log")

    def wal_flush(self) -> None:
        """Force every appended-but-uncommitted WAL record durable."""

    def wal_replay_records(self, after_lsn: int = 0):
        """Yield (lsn, op, arrays) of committed WAL records."""
        return iter(())

    def snapshot(self, state: dict) -> None:
        """Persist the full maintained state durably."""
        raise NotImplementedError("backend has no snapshot support")


class InMemoryBackend(MaintenanceBackend):
    """Host-resident graph, CSR indexes and int64 pid columns, with one
    signature store per level from `build_bisim(with_store=True)` on
    ``device``.

    Every gather is a batch array operation.  With `enable_device()` the
    per-level stores are mirrored into `DeviceSigStore`s, which become
    authoritative (every resolve, `add_nodes` included, runs on the
    device); the host `SigStore`s of `stores` are then lazy extractions.
    ``enable_device(store_on_device=False)`` keeps S_j on the host and
    moves only the fold (the out-of-core backend's arrangement).
    """

    def __init__(self, graph: Graph, *, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._device = False
        self._store_on_device = False
        self._dstores: Optional[list] = None
        self._stores: Optional[list] = None
        self._fold_cache: dict = {}
        self._resident_cache: dict = {}

    # ----------------------------------------------------- device capability
    def enable_device(self, store_on_device: bool = True) -> bool:
        """Switch propagation onto the device; the first decision on the
        store's placement is sticky across rebuilds."""
        if not self._device:
            self._device = True
            self._store_on_device = bool(store_on_device)
            if self._stores is not None and self._store_on_device:
                self._mirror_stores()
        return True

    def _mirror_stores(self) -> None:
        from .device_maint import DeviceSigStore
        self._dstores = [DeviceSigStore(s, self.device) for s in self._stores]
        # the mirrors are authoritative from here on
        self._stores = None

    @property
    def stores(self) -> list:
        """Per-level stores; with device stores each is re-materialized
        from its authoritative mirror."""
        if self._dstores is not None:
            return [d.to_host() for d in self._dstores]
        return self._stores

    @property
    def device_store_bytes(self) -> int:
        """Device bytes of the mirrored stores (0 without them)."""
        return sum(d.nbytes for d in self._dstores or ())

    # ------------------------------------------------------------ geometry
    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    # ------------------------------------------------------------- (re)build
    def build(self, k: int, mode: str, *,
              result: Optional[BisimResult] = None) -> None:
        if result is None:
            res = build_bisim(self.graph, k, mode=mode, early_stop=False,
                              with_store=True, device=self.device)
            stores = res.stores
        else:
            res = result
            if res.stores is None:
                raise ValueError("BisimMaintainer needs with_store=True "
                                 "results")
            # an injected result may feed several maintainers: resolving
            # into its stores in place would leak between them
            stores = [s.slice_copy() for s in res.stores]
        # pid history as mutable int64 (new pids can exceed int32 eventually)
        self.pids = [np.array(res.pids[j], dtype=np.int64)
                     for j in range(k + 1)]
        self._stores = stores        # list[SigStore]; [0] keyed by label
        self.next_pid = list(res.next_pid)
        self._refresh_indexes()
        if self._device and self._store_on_device:
            self._mirror_stores()    # a rebuild re-mirrors from scratch

    def _refresh_indexes(self) -> None:
        self.out_off = self.graph.out_offsets()
        self.in_ord = self.graph.in_order(self.device)
        self.in_off = self.graph.in_offsets()
        # every graph mutation funnels through here: drop the fold
        # batch's cached device constants (labels/seg/bounds/pId_0)
        self._fold_cache = {}
        self._resident_cache = {}

    # ---------------------------------------------------------- pid history
    def pid_column(self, j: int) -> np.ndarray:
        return self.pids[j]

    def pid_at(self, j: int, nodes: np.ndarray) -> np.ndarray:
        return self.pids[j][nodes]

    def set_pid_at(self, j: int, nodes: np.ndarray,
                   values: np.ndarray) -> None:
        self.pids[j][nodes] = values

    def append_pid_rows(self, j: int, values: np.ndarray) -> None:
        self.pids[j] = np.concatenate(
            [self.pids[j], np.asarray(values, dtype=np.int64)])

    # ---------------------------------------------------------------- store
    def resolve(self, j: int, keys: np.ndarray) -> np.ndarray:
        if self._dstores is not None:
            out, self.next_pid[j] = self._dstores[j].get_or_assign_keys(
                keys, self.next_pid[j])
            return out
        out, self.next_pid[j] = self._stores[j].get_or_assign(
            keys, self.next_pid[j])
        return out

    def resolve_pairs(self, j: int, hi, lo, count: int) -> np.ndarray:
        if self._dstores is not None:
            out, self.next_pid[j] = self._dstores[j].get_or_assign_pairs(
                hi, lo, count, self.next_pid[j])
            return out
        return super().resolve_pairs(j, hi, lo, count)

    # -------------------------------------------------------------- gathers
    def _gather_frontier(self, j: int, frontier: np.ndarray):
        """(pid0, seg, elabel, pid_tgt) of the frontier's out-edges — the
        shared input of the host and device signature folds."""
        idx, seg = _csr_gather(self.out_off, frontier)
        return (self.pids[0][frontier], seg, self.graph.elabel[idx],
                self.pids[j - 1][self.graph.dst[idx]])

    def frontier_signatures(self, j: int, frontier: np.ndarray, *,
                            dedup: bool = True):
        p0, seg, lab, pid_tgt = self._gather_frontier(j, frontier)
        return hashes_np.signatures_from_edges(
            p0, seg, lab, pid_tgt, frontier.size, dedup=dedup)

    def _frontier_bounds(self, frontier: np.ndarray) -> np.ndarray:
        """Segment boundaries of the frontier gather — free from CSR."""
        cnts = (self.out_off[frontier + 1]
                - self.out_off[frontier]).astype(np.int64)
        bounds = np.zeros(frontier.size + 1, np.int64)
        np.cumsum(cnts, out=bounds[1:])
        return bounds

    def frontier_signatures_device(self, j: int, frontier: np.ndarray, *,
                                   dedup: bool = True):
        if not self._device:
            return None
        from .device_maint import frontier_fold
        p0, seg, lab, pid_tgt = self._gather_frontier(j, frontier)
        return frontier_fold(p0, seg, lab, pid_tgt, frontier.size,
                             device=self.device, dedup=dedup,
                             bounds=self._frontier_bounds(frontier),
                             cache=self._fold_cache, cache_key=frontier)

    def propagate_level_resident(self, j: int, frontier: np.ndarray, *,
                                 dedup: bool = True):
        if not (self._device and self._dstores is not None):
            return None
        from .device_maint import resident_level_resolve
        p0, seg, lab, pid_tgt = self._gather_frontier(j, frontier)
        out, changed, n_changed, self.next_pid[j] = resident_level_resolve(
            self._dstores[j], p0, seg, lab, pid_tgt, frontier.size,
            self.pids[j][frontier], self.next_pid[j], dedup=dedup,
            bounds=self._frontier_bounds(frontier),
            cache=self._resident_cache, cache_key=frontier)
        return out, changed, n_changed

    def propagate_levels_resident(self, frontier: np.ndarray, *,
                                  dedup: bool = True):
        """The fused k-loop: one CSR gather feeds every level (the edge
        index set depends only on the frontier)."""
        if not (self._device and self._dstores is not None):
            return None
        from .device_maint import resident_levels_resolve
        k = len(self.pids) - 1
        if k == 0:
            return None
        idx, seg = _csr_gather(self.out_off, frontier)
        lab = self.graph.elabel[idx]
        dst = self.graph.dst[idx]
        nclean, dirty, next_pid_d = resident_levels_resolve(
            self._dstores[1:], self.pids[0][frontier], seg, lab,
            [self.pids[j - 1][dst] for j in range(1, k + 1)],
            frontier.size,
            [self.pids[j][frontier] for j in range(1, k + 1)],
            self.next_pid[1:], dedup=dedup,
            bounds=self._frontier_bounds(frontier),
            cache=self._resident_cache, cache_key=frontier)
        if dirty is not None:
            self.next_pid[nclean + 1] = next_pid_d
        return nclean, dirty

    def parents_of(self, nodes: np.ndarray) -> np.ndarray:
        idx, _ = _csr_gather(self.in_off, nodes)
        return np.unique(self.graph.src[self.in_ord[idx]]).astype(np.int64)

    def out_edges_of(self, nodes: np.ndarray):
        """(src, elabel, dst) of every out-edge of the sorted-unique
        ``nodes``, in the canonical (src, elabel, dst) order: the gather
        the quotient service patches touched blocks' rows from."""
        idx, _ = _csr_gather(self.out_off,
                             np.asarray(nodes, dtype=np.int64))
        g = self.graph
        return g.src[idx], g.elabel[idx], g.dst[idx]

    def node_labels_of(self, nodes: np.ndarray) -> np.ndarray:
        return self.graph.node_labels[np.asarray(nodes, dtype=np.int64)]

    def incident_edges(self, nid: int):
        g = self.graph
        mask = (g.src == nid) | (g.dst == nid)
        return g.src[mask], g.elabel[mask], g.dst[mask]

    # ------------------------------------------------------------ mutations
    def add_node_rows(self, labels: np.ndarray) -> int:
        base = self.graph.num_nodes
        self.graph = self.graph.with_nodes_added(labels)
        self._refresh_indexes()
        return base

    def add_edge_rows(self, src, elabel, dst) -> None:
        # Graph construction range-validates before this object is
        # committed, so a rejected insert leaves the backend untouched.
        self.graph = self.graph.with_edges_added(src, dst, elabel)
        self._refresh_indexes()

    def remove_edge_rows(self, src, elabel, dst) -> None:
        self.graph = self.graph.with_edges_removed(src, dst, elabel)
        self._refresh_indexes()

    def compact(self, keep: np.ndarray, remap: np.ndarray) -> None:
        g = self.graph
        # delete_node removed incident edges; keep only live-endpoint edges
        # anyway so a stale tombstone cannot corrupt the remap.
        emask = keep[g.src] & keep[g.dst]
        self.graph = Graph(
            g.node_labels[keep],
            remap[g.src[emask]].astype(np.int32),
            remap[g.dst[emask]].astype(np.int32),
            g.elabel[emask])  # monotone remap keeps (src,elabel,dst) order
        for j in range(len(self.pids)):
            self.pids[j] = self.pids[j][keep]
        self._refresh_indexes()

    # -------------------------------------------------------------- change k
    def truncate_k(self, new_k: int) -> None:
        self.pids = self.pids[: new_k + 1]
        if self._stores is not None:
            self._stores = self._stores[: new_k + 1]
        if self._dstores is not None:
            self._dstores = self._dstores[: new_k + 1]
        self.next_pid = self.next_pid[: new_k + 1]

    def extend_k(self, new_k: int, mode: str) -> None:
        """Additional iterations bottom-up from the stored pId_k, through
        the build's own step (`partition.bisim_step`) on ``device``."""
        g = self.graph
        cur_k = len(self.pids) - 1
        pid0, src, dst, elab, pid_prev = (
            torch.from_numpy(np.asarray(x, dtype=np.int32)).to(self.device)
            for x in (self.pids[0], g.src, g.dst, g.elabel,
                      self.pids[cur_k]))
        elabel_range = ((int(g.elabel.min()), int(g.elabel.max()))
                        if g.num_edges else (0, 0))
        # maintained pids are not dense ranks: they reach next_pid
        pid_bound = max(g.num_nodes, self.next_pid[cur_k])
        for _ in range(cur_k + 1, new_k + 1):
            pid_new, count, hi, lo = bisim_step(
                pid0, src, dst, elab, pid_prev, num_nodes=g.num_nodes,
                mode=mode, elabel_range=elabel_range, pid_bound=pid_bound)
            pid_np = pid_new.cpu().numpy()
            store = SigStore.from_hash_pairs(hi.cpu().numpy(),
                                             lo.cpu().numpy(), pid_np)
            if self._dstores is not None:
                from .device_maint import DeviceSigStore
                self._dstores.append(DeviceSigStore(store, self.device))
            else:
                self._stores.append(store)
            self.next_pid.append(int(count))
            self.pids.append(pid_np.astype(np.int64))
            pid_prev = pid_new


class BisimMaintainer:
    """Holds a k-bisimulation partition and applies updates — the paper's
    update semantics over any `MaintenanceBackend`.

    Pass a `Graph` (wrapped in an `InMemoryBackend` on ``device``) or a
    ready backend, whose own device then holds.  ``device`` is the card
    unless ``"cpu"`` is asked for, and raises without one.

    ``device_propagation`` (default True) propagates on the device; False
    asks for the numpy host path.  A backend without the capability makes
    the constructor raise, and a failure on the device path raises: the
    port has no silent or degrading fallback (the reference's
    ``device: bool`` had both).

    ``wal=True`` logs every logical update to the backend's write-ahead
    log before applying it (the redo rule), so `snapshot()` and
    `BisimMaintainer.restore` recover the maintained partition after a
    crash.  It needs a backend with ``wal_supported``
    (`exmem.OocBackend(wal=True)`) and raises on any other.
    """

    def __init__(self, graph, k: int, *, mode: str = "sorted",
                 rebuild_threshold: float = 0.5,
                 result: Optional[BisimResult] = None, device=None,
                 device_propagation: bool = True, wal: bool = False):
        if mode not in ("sorted", "dedup_hash", "multiset"):
            raise ValueError(f"unknown signature mode: {mode}")
        self.k = k
        self.mode = mode
        self.rebuild_threshold = rebuild_threshold
        if isinstance(graph, MaintenanceBackend):
            self.backend = graph
            if device is not None and \
                    torch.device(device) != self.backend.device:
                raise ValueError(
                    f"device {device} differs from the backend's "
                    f"{self.backend.device}")
        else:
            self.backend = InMemoryBackend(graph, device=device)
        if wal and not self.backend.wal_supported:
            raise ValueError(
                "wal=True requires a backend with a write-ahead log "
                "(OocBackend(wal=True)); refusing to silently drop "
                "durability")
        self.wal = bool(wal)
        self._in_replay = False
        self._wal_depth = 0
        self.device = self.backend.device
        # delete_node leaves an isolated tombstone row (dense id space);
        # compact() later drops the flagged rows and remaps ids.
        self._tombstone = np.zeros(self.backend.num_nodes, dtype=bool)
        self.backend.build(k, mode, result=result)
        self.device_propagation = bool(device_propagation)
        if self.device_propagation and not self.backend.enable_device():
            raise ValueError(
                f"{type(self.backend).__name__} has no device propagation; "
                "pass device_propagation=False for the host path")
        # per-level changed-node sets of the LAST update (index j = nodes
        # whose pId_j changed, 0..k); None = "assume everything changed"
        # (fresh build, §4.2 rebuild, compact, change_k).  The quotient
        # service reads this to patch touched blocks.
        self.last_changed = None
        # optional scheduling hook: called as on_rebuild(level, frontier)
        # whenever the §4.2 heuristic fires mid-propagation, so a service
        # loop can account for the rebuild (e.g. force an early snapshot)
        self.on_rebuild = None

    # ------------------------------------------------------------ durability
    @contextlib.contextmanager
    def _logged(self, op: str, **arrays):
        """Write-ahead one logical update (the record reaches the log
        before the mutation starts), then run it.  Nested ops
        (delete_node's inner delete_edges) and replayed ops are not
        logged again: the log holds outermost logical updates only."""
        if self.wal and not self._in_replay and not self._wal_depth:
            self.backend.wal_append(op, arrays)
        self._wal_depth += 1
        try:
            yield
        finally:
            self._wal_depth -= 1

    @contextlib.contextmanager
    def already_logged(self):
        """Run update methods without logging them: for callers that
        appended the records to the log themselves, before applying."""
        self._wal_depth += 1
        try:
            yield
        finally:
            self._wal_depth -= 1

    def apply_ops(self, ops, *, logged: bool = True):
        """Apply a batch of mixed logical updates in order.

        ``ops`` is an iterable of ``(op_name, arrays)`` pairs in
        `_REPLAY_OPS` form (the WAL's record vocabulary).  Application
        order is the given order, so the pid history equals applying each
        op on its own, and a WAL replay of the same records.
        ``logged=False`` declares the records already logged by the
        caller: nothing is logged again, and the ops the backend rejects
        (ValueError/OverflowError) are skipped and counted, as replay
        skips them; ``logged=True`` logs each op and re-raises them.

        Returns ``(report, rejected)``: the merged `MaintenanceReport`
        (padded to k levels) and the rejected-op count.  Afterwards
        `last_changed` holds the per-level union of every applied op's
        changed sets (None if any op poisoned it).
        """
        merged = MaintenanceReport([], [], [],
                                   device=self.device_propagation)
        union = [np.empty(0, dtype=np.int64) for _ in range(self.k + 1)]
        poisoned = False
        rejected = 0
        ctx = contextlib.nullcontext if logged else self.already_logged
        with ctx():
            for op, arrays in ops:
                self.last_changed = None
                try:
                    out = self._REPLAY_OPS[op](self, arrays)
                except (ValueError, OverflowError):
                    if logged:
                        raise
                    rejected += 1
                    continue
                if isinstance(out, MaintenanceReport):
                    merged.merge(out)
                if poisoned:
                    continue
                if self.last_changed is None or op == "change_k":
                    poisoned = True  # everything, or the level count, moved
                else:
                    if len(self.last_changed) > len(union):
                        union.extend(np.empty(0, dtype=np.int64)
                                     for _ in range(len(self.last_changed)
                                                    - len(union)))
                    union = [np.union1d(u, c) for u, c in
                             zip(union, self.last_changed)]
        self.last_changed = None if poisoned else union
        return self._pad_report(merged), rejected

    def snapshot(self) -> None:
        """Persist the maintained partition durably: commit the log, then
        hand the backend what a restore needs beyond its own storage (k,
        mode, tombstones, whether the log is on).  The backend prunes the
        records the snapshot absorbed."""
        if self.wal:
            self.backend.wal_flush()
        self.backend.snapshot(dict(
            k=int(self.k), mode=self.mode,
            rebuild_threshold=float(self.rebuild_threshold),
            wal=bool(self.wal),
            tombstone=np.asarray(self._tombstone, dtype=bool)))

    _REPLAY_OPS = {
        "add_nodes": lambda m, a: m.add_nodes(a["labels"]),
        "add_edges": lambda m, a: m.add_edges(a["src"], a["elabel"],
                                              a["dst"]),
        "delete_edges": lambda m, a: m.delete_edges(a["src"], a["elabel"],
                                                    a["dst"]),
        "delete_node": lambda m, a: m.delete_node(int(a["nid"][0])),
        "compact": lambda m, a: m.compact(),
        "change_k": lambda m, a: m.change_k(int(a["new_k"][0])),
    }

    @classmethod
    def restore(cls, backend: MaintenanceBackend, state: dict, *,
                device_propagation: bool = True) -> "BisimMaintainer":
        """A maintainer over a backend's restored snapshot (``(backend,
        state)`` from `exmem.OocBackend.restore`), with every committed
        WAL record past the snapshot's lsn replayed through the update
        methods.  The pre-crash live state is not consulted: recovery is
        snapshot plus committed redo, so a crash mid-update never leaves
        a partly applied batch.  ``device_propagation`` as in the
        constructor: it raises on a backend without the capability."""
        m = object.__new__(cls)
        m.k = int(state["k"])
        m.mode = state["mode"]
        m.rebuild_threshold = float(state["rebuild_threshold"])
        m.backend = backend
        m.device = backend.device
        m.wal = bool(state.get("wal", False)) and backend.wal_supported
        m._wal_depth = 0
        m._tombstone = np.asarray(state["tombstone"], dtype=bool)
        m.device_propagation = bool(device_propagation)
        if m.device_propagation and not backend.enable_device():
            raise ValueError(
                f"{type(backend).__name__} has no device propagation; "
                "pass device_propagation=False for the host path")
        m.last_changed = None
        m.on_rebuild = None
        m._in_replay = True
        try:
            for _lsn, op, arrays in backend.wal_replay_records(
                    after_lsn=int(state.get("wal_lsn", 0))):
                try:
                    cls._REPLAY_OPS[op](m, arrays)
                except (ValueError, OverflowError):
                    # the record reaches the log before validation, so an
                    # op the backend rejected is logged too; it left no
                    # state behind then and raises the same way now
                    pass
        finally:
            m._in_replay = False
        return m

    # ------------------------------------------------------------- queries
    @property
    def graph(self) -> Graph:
        """The maintained graph; the out-of-core backend materializes a
        copy (tests and small graphs only)."""
        return self.backend.graph

    @property
    def pids(self) -> list:
        """Per-level pid columns; live arrays for the in-memory backend."""
        backend_pids = getattr(self.backend, "pids", None)
        if backend_pids is not None:
            return backend_pids
        return [self.backend.pid_column(j) for j in range(self.k + 1)]

    @property
    def stores(self) -> list:
        return self.backend.stores

    @property
    def next_pid(self) -> list:
        return self.backend.next_pid

    def pid(self, j: Optional[int] = None) -> np.ndarray:
        return self.backend.pid_column(self.k if j is None else j)

    def result(self) -> BisimResult:
        pids = [np.asarray(self.backend.pid_column(j), dtype=np.int64)
                for j in range(self.k + 1)]
        return BisimResult(
            pids=np.stack(pids),
            counts=[len(np.unique(p)) for p in pids], stats=[],
            converged_at=None, k_requested=self.k)

    # ------------------------------------------------------- ADD_NODE(S)
    def add_node(self, label: int) -> int:
        """Algorithm 2: add one isolated node."""
        return self.add_nodes([label])[0]

    def add_nodes(self, labels: Iterable[int]) -> list:
        """Algorithm 3: bulk insert isolated nodes (merge-join on labels)."""
        labels = np.asarray(list(labels), dtype=np.int32)
        with self._logged("add_nodes", labels=labels):
            base = self.backend.add_node_rows(labels)
            new_ids = list(range(base, base + labels.shape[0]))
            self._tombstone = np.concatenate(
                [self._tombstone, np.zeros(labels.shape[0], dtype=bool)])
            # level 0: one bulk resolve of the label keys (merge-join)
            p0 = self.backend.resolve(0, label_key(labels))
            self.backend.append_pid_rows(0, p0)
            # sig_j of an isolated node is (pId_0, {}) for every j >= 1:
            # the empty-set combine is the identity (0, 0), so its hash
            # only depends on p0 — one vectorized hash_triple per level.
            zero = np.zeros(labels.shape[0], np.uint32)
            hi, lo = hashes_np.hash_triple(zero, zero, p0)
            keys = fuse_key(hi, lo)
            for j in range(1, self.k + 1):
                self.backend.append_pid_rows(j,
                                             self.backend.resolve(j, keys))
            ids64 = np.asarray(new_ids, dtype=np.int64)
            self.last_changed = [ids64.copy() for _ in range(self.k + 1)]
        return new_ids

    # ------------------------------------------------------- ADD_EDGE(S)
    def add_edges(self, src, elabel, dst) -> MaintenanceReport:
        """Algorithm 4 (and its ADD_EDGES batch variant)."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        elabel = np.atleast_1d(np.asarray(elabel, dtype=np.int32))
        with self._logged("add_edges", src=src, elabel=elabel, dst=dst):
            # the backend range-validates before mutating, so a rejected
            # insert must not re-animate anything
            self.backend.add_edge_rows(src, elabel, dst)
            # an edge incident to a tombstoned node re-animates it
            self._tombstone[src] = False
            self._tombstone[dst] = False
            return self._propagate(frontier0=np.unique(src))

    def add_edge(self, s: int, l: int, t: int) -> MaintenanceReport:
        return self.add_edges([s], [l], [t])

    def delete_edges(self, src, elabel, dst) -> MaintenanceReport:
        """Deletions (§4): same propagation pattern as insertion."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        elabel = np.atleast_1d(np.asarray(elabel, dtype=np.int32))
        with self._logged("delete_edges", src=src, elabel=elabel, dst=dst):
            self.backend.remove_edge_rows(src, elabel, dst)
            return self._propagate(frontier0=np.unique(src))

    def delete_node(self, nid: int) -> MaintenanceReport:
        """Remove a node: first its incident edges, then the node row."""
        if not 0 <= nid < self.backend.num_nodes:
            # reject before any mutation (negative ids would wrap around
            # and tombstone a live row)
            raise ValueError(f"node id out of range: {nid}")
        with self._logged("delete_node",
                          nid=np.asarray([nid], dtype=np.int64)):
            src, elabel, dst = self.backend.incident_edges(nid)
            rep = self.delete_edges(src, elabel, dst)
            # The paper then drops the N_t row; a tombstone (isolated
            # node) keeps the dense id space until compact() runs.
            self._tombstone[nid] = True
        return rep

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows: densely remap node ids, slice the pid
        history, and rebuild the edge tables (the deferred half of the
        paper's DELETE_NODE).

        Returns the old->new id map (int64 [old_N]; -1 for dropped rows).
        The stores are untouched: they map signatures, not node ids.
        """
        dead = self._tombstone
        remap = np.cumsum(~dead, dtype=np.int64) - 1
        remap[dead] = -1
        if not dead.any():
            empty = np.empty(0, dtype=np.int64)
            self.last_changed = [empty.copy() for _ in range(self.k + 1)]
            return remap
        with self._logged("compact"):
            self.backend.compact(~dead, remap)
            self._tombstone = np.zeros(self.backend.num_nodes, dtype=bool)
            self.last_changed = None  # node ids moved: everything changed
        return remap

    @property
    def num_tombstones(self) -> int:
        return int(self._tombstone.sum())

    # ------------------------------------------------------- propagation
    def _pad_report(self, report: MaintenanceReport) -> MaintenanceReport:
        """Pad the per-level lists to k entries (zeros) — the §4.2 rebuild
        returns mid-loop, and consumers index by level."""
        while len(report.nodes_checked) < self.k:
            report.nodes_checked.append(0)
            report.nodes_changed.append(0)
            report.partitions_touched.append(0)
            report.level_seconds.append(0.0)
        return report

    def _propagate(self, frontier0: np.ndarray) -> MaintenanceReport:
        with obs.span("maint.propagate", frontier=int(frontier0.size),
                      device=self.device_propagation):
            return self._propagate_inner(frontier0)

    def _device_level(self, j: int, frontier: np.ndarray, dedup: bool):
        """One device level: the fused resident level when the stores are
        on the device, else the fold on the device and the resolve on the
        host store.  Returns (resident triple or None, pj or None)."""
        fault_point("device", f"level {j}")
        resident = self.backend.propagate_level_resident(j, frontier,
                                                         dedup=dedup)
        if resident is not None:
            return resident, None
        pj = self.backend.propagate_level_device(j, frontier, dedup=dedup)
        if pj is None:
            raise RuntimeError(f"{type(self.backend).__name__} lost its "
                               "device propagation")
        return None, pj

    def _propagate_inner(self, frontier0: np.ndarray) -> MaintenanceReport:
        n = self.backend.num_nodes
        report = MaintenanceReport([], [], [],
                                   device=self.device_propagation)
        # pId_0 never moves under edge updates; levels 1..k fill in below
        changed_levels = [np.empty(0, dtype=np.int64)]
        dedup = self.mode != "multiset"
        frontier = np.unique(frontier0).astype(np.int64)
        always = frontier.copy()  # (j, s) enqueued for every j (line 7-8)
        # fused k-loop prefix: every level resolves in one pass while
        # nothing changes; the first change invalidates the later levels'
        # uploaded target pids and hands back to the per-level ladder
        nclean, dirty_commit, dt_fused = 0, None, 0.0
        if self.device_propagation and frontier.size \
                and frontier.size <= self.rebuild_threshold * n:
            t0 = time.perf_counter()
            fault_point("device", "level 1")
            multi = self.backend.propagate_levels_resident(frontier,
                                                           dedup=dedup)
            if multi is not None:
                nclean, dirty_commit = multi
                # amortize the single pass over the levels it settled
                dt_fused = (time.perf_counter() - t0) / max(
                    nclean + (dirty_commit is not None), 1)
        fused_until = nclean + (dirty_commit is not None)
        for j in range(1, self.k + 1):
            t0 = time.perf_counter()
            if frontier.size == 0:
                report.nodes_checked.append(0)
                report.nodes_changed.append(0)
                report.partitions_touched.append(0)
                report.level_seconds.append(0.0)
                changed_levels.append(np.empty(0, dtype=np.int64))
                continue
            if frontier.size > self.rebuild_threshold * n:
                # §4.2 heuristic: most nodes queued -> full rebuild is cheaper
                with obs.span("maint.rebuild", level=j):
                    self.backend.build(self.k, self.mode)
                report.rebuilt = True
                self.last_changed = None  # rebuild re-ranks every level
                if self.on_rebuild is not None:
                    self.on_rebuild(j, int(frontier.size))
                return self._pad_report(report)
            with obs.span("maint.level", level=j,
                          frontier=int(frontier.size),
                          device=self.device_propagation) as lvl_sp:
                pj = None
                resident = None
                if j <= nclean:
                    # settled by the fused k-loop: confirmed unchanged
                    resident = (None, None, 0)
                elif j == nclean + 1 and dirty_commit is not None:
                    resident = dirty_commit
                    dirty_commit = None
                elif self.device_propagation:
                    resident, pj = self._device_level(j, frontier, dedup)
                if resident is not None:
                    # fused level: pid deltas crossed back only if
                    # something changed
                    pj_full, changed_mask, n_changed = resident
                    if n_changed:
                        old = self.backend.pid_at(j, frontier)
                        self.backend.set_pid_at(j, frontier, pj_full)
                        changed = frontier[changed_mask]
                        touched = int(np.union1d(
                            old[changed_mask], pj_full[changed_mask]).size)
                    else:
                        changed = frontier[:0]
                        touched = 0
                    lvl_sp.set(changed=int(changed.size))
                    report.nodes_checked.append(int(frontier.size))
                    report.nodes_changed.append(int(changed.size))
                    report.partitions_touched.append(touched)
                else:
                    if pj is None:
                        hi, lo = self.backend.frontier_signatures(
                            j, frontier, dedup=dedup)
                        # one bulk resolve of the frontier against S_j
                        pj = self.backend.resolve(j, fuse_key(hi, lo))
                    old = self.backend.pid_at(j, frontier)
                    changed_mask = old != pj
                    self.backend.set_pid_at(j, frontier, pj)
                    changed = frontier[changed_mask]
                    lvl_sp.set(changed=int(changed.size))
                    report.nodes_checked.append(int(frontier.size))
                    report.nodes_changed.append(int(changed.size))
                    report.partitions_touched.append(
                        int(np.union1d(old[changed_mask],
                                       pj[changed_mask]).size))
                changed_levels.append(np.asarray(changed, dtype=np.int64))
                # propagate to parents of changed nodes (line 20; E_tts)
                if changed.size and j < self.k:
                    frontier = np.union1d(self.backend.parents_of(changed),
                                          always)
                else:
                    frontier = always.copy()
            report.level_seconds.append(
                time.perf_counter() - t0
                + (dt_fused if j <= fused_until else 0.0))
        self.last_changed = changed_levels
        return report

    # ---------------------------------------------------------- change k
    def change_k(self, new_k: int) -> None:
        """§4 'Change k': decrease slices history; increase runs extra
        iterations of Algorithm 1 on top of the stored state."""
        with self._logged("change_k",
                          new_k=np.asarray([new_k], dtype=np.int64)):
            if new_k <= self.k:
                self.backend.truncate_k(new_k)
            else:
                self.backend.extend_k(new_k, self.mode)
            self.k = new_k
            self.last_changed = None  # the level ladder itself moved
