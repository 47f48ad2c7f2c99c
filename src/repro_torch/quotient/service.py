"""Liveness: keep a served quotient artifact consistent with a
`BisimMaintainer` that is streaming updates underneath it.

After every update batch the maintainer records which nodes changed
pid per level (`maintainer.last_changed`); the service turns that into
an *incremental patch* of the artifact:

* one `out_edges_of` gather over the union of changed nodes (a single
  E_tst scan on the out-of-core backend),
* per touched level, the changed sources' rows are mapped to
  (pId_j(src), eLabel, pId_{j-1}(dst)) and merge-inserted into the
  level's `OocGraph` (`insert_edges` — the same `core/kway.py`
  emit-boundary merge the maintainer itself uses), after growing the
  level's pid id-space to the maintainer's `next_pid`,
* the extent runs are spliced in place (only runs overlapping changed
  node-id intervals are rewritten) and the block-label columns are
  scatter-updated.

Why insert-only is enough: pId_j(u) changes iff sig_j(u) changes, the
quotient rows of a block are exactly the (uniform) signature of its
members, and a target pid change that alters a source's out-set always
propagates that source into ``changed[j]``.  A block that loses every
member keeps its stale rows, but no live block's rows reference an
empty block, and stale blocks expand to zero node ids — so stale rows
are unreachable from answers (package docstring, "Epoch / staleness
contract").

Full rematerialization happens only when the per-level change sets are
unavailable because ids or levels themselves moved: a §4.2 rebuild, a
`compact`, or a `change_k`.

Epochs: every absorbed batch advances `service.epoch` by one.  The
host index is patched first; the engine keeps serving the previous
snapshot's device arrays until `engine.refresh(touched)` swaps them
and the epoch together, so a query never observes a half-applied
patch.

The port's copy of `repro.quotient.service` over the port's maintainer;
its engine runs on the maintainer's device unless ``device`` says
otherwise.
"""
from __future__ import annotations

import os
import threading
from typing import List

import numpy as np

from ..exmem.runs import IOStats
from ..obs import tracer as obs

from .engine import QuotientEngine
from .materialize import ExtentRuns, materialize_quotient

_INT32 = np.int32


class QuotientService:
    """Owns a `BisimMaintainer` and a served `QuotientIndex`; every
    mutator wraps the maintainer's and absorbs the result into the
    artifact before returning.

    Admission: `query` takes no lock — it reads the engine's pinned
    epoch view, so queries admitted during an in-flight patch answer
    against the pre-patch epoch instead of queueing behind it.
    Mutators (and `absorb`) serialize on one host lock."""

    def __init__(self, maintainer, workdir: str, *,
                 max_batch: int = 64, budget_rows: int = 1 << 16,
                 aio=None, device=None):
        self.m = maintainer
        self.root = os.path.join(workdir, "quotient")
        self.budget_rows = int(budget_rows)
        self.aio = aio
        self.io = IOStats()
        self.epoch = 0
        self._mut = threading.Lock()
        self.index = self._materialize()
        self.engine = QuotientEngine(
            self.index, max_batch=max_batch,
            device=maintainer.device if device is None else device)
        self.patches = 0          # incremental absorptions
        self.rematerializations = 0

    # ------------------------------------------------------------- queries
    def query(self, queries: List) -> List:
        # lock-free: the engine pins its current epoch view once per call
        return self.engine.query(queries)

    # ------------------------------------------------------------ mutators
    def add_edges(self, src, elabel, dst):
        with self._mut:
            rep = self.m.add_edges(src, elabel, dst)
            self._absorb()
        return rep

    def delete_edges(self, src, elabel, dst):
        with self._mut:
            rep = self.m.delete_edges(src, elabel, dst)
            self._absorb()
        return rep

    def delete_node(self, nid: int):
        with self._mut:
            rep = self.m.delete_node(nid)
            self._absorb()
        return rep

    def add_nodes(self, labels) -> list:
        with self._mut:
            ids = self.m.add_nodes(labels)
            self._absorb()
        return ids

    def compact(self) -> np.ndarray:
        with self._mut:
            remap = self.m.compact()
            self._absorb()
        return remap

    def change_k(self, new_k: int) -> None:
        with self._mut:
            self.m.change_k(new_k)
            self._absorb()

    def absorb(self) -> None:
        """Advance the served artifact to the maintainer's current state
        — for callers that applied updates directly on the maintainer
        (the streaming service's batch loop) rather than through the
        mutators above.  Uses `maintainer.last_changed` exactly like the
        wrapped mutators do."""
        with self._mut:
            self._absorb()

    # ----------------------------------------------------------- absorption
    def _graph_handle(self):
        """The maintained graph for materialization: the backing
        `OocGraph` when out-of-core (streamed, IO-charged), else the
        in-memory `Graph`."""
        ooc = getattr(self.m.backend, "ooc", None)
        return ooc if ooc is not None else self.m.backend.graph

    def _materialize(self):
        # the backend itself is the pid history: OocBackend exposes
        # `pid_paths` (memory-mapped, never fully loaded), the
        # in-memory backend `pids`
        index = materialize_quotient(
            self._graph_handle(), self.m.backend, self.root,
            counts=[int(x) for x in self.m.next_pid], mode=self.m.mode,
            budget_rows=self.budget_rows, stats=self.io, aio=self.aio,
            overwrite=True)
        index.epoch = self.epoch
        index.write_meta()
        return index

    def _absorb(self) -> None:
        """Advance the served artifact to the maintainer's new state:
        patch the touched blocks, or rematerialize when per-level
        change sets are unavailable."""
        self.epoch += 1
        changed = self.m.last_changed
        rematerialize = (changed is None or self.m.k != self.index.k)
        with obs.span("quotient.patch", epoch=self.epoch,
                      rematerialize=rematerialize, io=self.io):
            if rematerialize:
                self.index = self._materialize()
                self.rematerializations += 1
                self.engine.rebind(self.index)
            else:
                touched = self._patch(changed)
                self.patches += 1
                self.index.epoch = self.epoch
                self.index.write_meta()
                # the swap: until here every query read the previous
                # snapshot's device arrays
                self.engine.refresh(sorted(touched))
        obs.event("quotient.epoch", epoch=self.epoch,
                  rematerialized=rematerialize)

    # ---------------------------------------------------------------- patch
    def _patch(self, changed: List[np.ndarray]) -> set:
        """Insert-only incremental patch; returns the set of levels
        whose device arrays must be re-uploaded."""
        backend = self.m.backend
        idx = self.index
        k = idx.k
        counts_new = [int(x) for x in self.m.next_pid]
        n_new = int(backend.num_nodes)

        # one gather of every changed node's out-edges (single E_tst
        # scan out-of-core); rows arrive in canonical (src,elabel,dst)
        # order, so per-level selections stay src-ascending
        parts = [c for c in changed[1:] if c.size]
        union = (np.unique(np.concatenate(parts)) if parts
                 else np.empty(0, np.int64))
        e_src, e_lab, e_dst = backend.out_edges_of(union)
        e_src = np.asarray(e_src, dtype=np.int64)
        e_dst = np.asarray(e_dst, dtype=np.int64)

        touched: set = set()
        for j in range(1, k + 1):
            ch = changed[j]
            if ch.size == 0:
                continue
            touched.add(j)
            # grow the level's pid id-space first: insert_edges
            # range-validates endpoints against num_nodes
            g = idx.graphs[j]
            n_q = max(counts_new[j], counts_new[j - 1], 1)
            if n_q > g.num_nodes:
                g.append_nodes(np.full(n_q - g.num_nodes, -1, _INT32),
                               stats=self.io)
            # the changed sources' current rows at this level
            pos = (np.minimum(np.searchsorted(ch, e_src), ch.shape[0] - 1)
                   if ch.size else np.empty(0, np.int64))
            sel = ch[pos] == e_src if ch.size else np.empty(0, bool)
            es, ls, ds = e_src[sel], e_lab[sel], e_dst[sel]
            if es.size:
                ps = np.asarray(backend.pid_at(j, es), dtype=np.int64)
                # target pids via the sorted merge-join idiom: sort by
                # target, gather sequentially, scatter back
                order = np.argsort(ds, kind="stable")
                pt = np.empty(ds.shape[0], np.int64)
                pt[order] = np.asarray(
                    backend.pid_at(j - 1, ds[order]), dtype=np.int64)
                self.io.count_sort(ds.shape[0], ds.nbytes)
                rows = np.empty(es.shape[0], dtype=[
                    ("ps", np.int64), ("el", np.int64), ("pt", np.int64)])
                rows["ps"], rows["el"], rows["pt"] = ps, ls, pt
                rows = np.unique(rows)
                g.insert_edges(rows["ps"].astype(_INT32),
                               rows["el"].astype(_INT32),
                               rows["pt"].astype(_INT32), stats=self.io)
            idx.refresh_level(j, self.io)

        # extents + block labels for every level with pid changes.
        # Copy-on-write throughout: a pinned engine view may still be
        # answering from the old runs/labels objects, so they are
        # replaced, never mutated in place.
        for j in range(k + 1):
            ch = changed[j]
            if idx.runs[j].n_blocks != counts_new[j]:
                r = idx.runs[j]
                idx.runs[j] = ExtentRuns(r.start, r.pid, r.num_nodes,
                                         counts_new[j])
            if ch.size == 0:
                continue
            pids = np.asarray(backend.pid_at(j, ch), dtype=np.int64)
            idx.runs[j] = idx.runs[j].splice(
                ch, pids, num_nodes=n_new, n_blocks=counts_new[j])
            self.io.count_sort(ch.shape[0], ch.nbytes)
            lab_old = idx.labels[j]
            if counts_new[j] > lab_old.shape[0]:
                grown = np.full(counts_new[j], -1, _INT32)
                grown[:lab_old.shape[0]] = lab_old
            else:
                grown = lab_old.copy()
            grown[pids] = backend.node_labels_of(ch)
            idx.labels[j] = grown

        idx.counts = counts_new
        idx.num_nodes = n_new
        return touched
