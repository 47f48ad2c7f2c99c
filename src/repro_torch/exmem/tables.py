"""Disk-resident N_t / E_t column tables (paper §2, Tables 2-3).

`OocGraph` is the out-of-core sibling of `repro_torch.graph.storage.Graph`: the
same <N, E, lambda_N, lambda_E> data, but held as chunked ``.npy`` files in
a directory so graph size is independent of RAM.  Exactly the layouts the
paper's Algorithm 1 needs are materialized:

  nodes/       N_t: `nLabel` records, chunk files of `chunk_nodes` rows
  edges_tst/   E_tst: (sId, eLabel, tId) sorted by (sId, eLabel, tId)
  edges_tts/   E_tts: (tId, sId, eLabel) sorted by (tId, sId)
  meta.json    sizes + chunk geometry

Chunks are iterated via memory-maps, so a scan's resident set is one chunk.
`Graph.to_ooc()` / `OocGraph.to_memory()` convert between the two worlds;
`save`/`load` give the directory format a stable on-disk identity.

The tables are *maintainable* in place (paper §4's N_t/E_t updates):
`append_nodes` grows N_t, `insert_edges` / `delete_edges` rewrite the two
edge sort orders — insertion is a 2-way emit-boundary merge of the new
(sorted) batch against the chunk stream through the shared
`core.kway.merge_sorted_sources` core, deletion a filtered scan — and
`compact_rows` drops node rows with a monotone id remap.  Every rewrite
streams chunk by chunk into a fresh directory that is swapped in whole
(the old table is renamed aside until the new one is in place), so
resident memory stays a constant number of chunks and a partially
written table is never visible under the live name.  The swap of the
two edge orders plus the meta rewrite is *not* transactional: a crash
mid-update can leave the directory needing a rebuild from the maintained
graph — callers (the maintenance backend) treat it as scratch state and
recover via snapshot + WAL replay (`exmem.durability`).

Durability: every chunk's CRC-32 is recorded (computed from the bytes
already in memory at write time — zero extra I/O) in a ``manifest.json``
written atomically next to ``meta.json``.  `OocGraph.load` verifies the
whole manifest by default, so a torn chunk, a flipped byte, or a
truncated table raises `repro_torch.core.integrity.ChecksumError` at open
instead of surfacing as a silently wrong partition.

The port's own copy of `repro.exmem.tables` (numpy only).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..core.faults import fault_point, with_retries
from ..core.integrity import ChecksumError, crc32_array
from ..core.kway import merge_sorted_sources
from ..graph.storage import Graph
from ..obs import tracer as obs

from . import aio as aio_mod
from .durability import Manifest
from .runs import IOStats, rebuffer

NODE_DTYPE = np.dtype([("label", "<i4")])
TST_DTYPE = np.dtype([("src", "<i4"), ("elabel", "<i4"), ("dst", "<i4")])
TTS_DTYPE = np.dtype([("dst", "<i4"), ("src", "<i4"), ("elabel", "<i4")])

_META = "meta.json"
_FORMAT_VERSION = 1


def _write_chunked(table_dir: str, rec: np.ndarray,
                   chunk_rows: int) -> Tuple[int, dict]:
    os.makedirs(table_dir, exist_ok=True)
    name = os.path.basename(table_dir)
    n_chunks, sums = 0, {}
    for i, s in enumerate(range(0, rec.shape[0], chunk_rows)):
        part = rec[s:s + chunk_rows]
        aio_mod.atomic_save(os.path.join(table_dir, f"chunk_{i:06d}.npy"),
                            part)
        sums[f"{name}/chunk_{i:06d}.npy"] = [int(part.shape[0]),
                                             crc32_array(part)]
        n_chunks += 1
    return n_chunks, sums


class ChunkedColumn:
    """Lazy read-only column over chunked `.npy` files, sliceable like one
    long array — exactly the source shape `core.kway.merge_sorted_sources`
    consumes, so a whole on-disk table can enter a k-way merge without
    being materialized.  ``field`` selects one structured field; ``None``
    yields whole records (the payload-column idiom)."""

    def __init__(self, paths: Sequence[str], field: Optional[str] = None):
        self._arrs = [np.load(p, mmap_mode="r") for p in paths]
        self._field = field
        self._starts = np.cumsum([0] + [a.shape[0] for a in self._arrs])

    @property
    def shape(self) -> tuple:
        return (int(self._starts[-1]),)

    def __getitem__(self, sl: slice) -> np.ndarray:
        start, stop, step = sl.indices(self.shape[0])
        if step != 1:
            raise ValueError("ChunkedColumn supports unit-stride slices")
        parts = []
        i = int(np.searchsorted(self._starts, start, side="right")) - 1
        i = max(i, 0)
        while i < len(self._arrs) and self._starts[i] < stop:
            a = self._arrs[i]
            s = max(start - int(self._starts[i]), 0)
            e = min(stop - int(self._starts[i]), a.shape[0])
            if s < e:
                part = a[s:e]
                parts.append(part if self._field is None
                             else part[self._field])
            i += 1
        if not parts:
            dt = (self._arrs[0].dtype if self._field is None
                  else self._arrs[0].dtype[self._field]) if self._arrs \
                else np.dtype(np.int32)
            return np.empty(0, dt)
        if len(parts) == 1:
            return np.asarray(parts[0])
        return np.concatenate([np.asarray(p) for p in parts])


class OocGraph:
    """Chunked on-disk graph tables bound to a directory.

    ``aio`` (an `exmem.aio.AioConfig`, settable any time) threads every
    chunk scan through a `PrefetchReader` and every table rewrite through
    async chunk saves — same bytes, same `IOStats`, overlapped wall time.
    """

    def __init__(self, root: str, *,
                 aio: "Optional[aio_mod.AioConfig]" = None):
        self.root = root
        self.aio = aio
        with open(os.path.join(root, _META)) as f:
            meta = json.load(f)
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported OocGraph format: {meta}")
        self.num_nodes = int(meta["num_nodes"])
        self.num_edges = int(meta["num_edges"])
        self.chunk_nodes = int(meta["chunk_nodes"])
        self.chunk_edges = int(meta["chunk_edges"])
        self.num_node_chunks = int(meta["num_node_chunks"])
        self.num_edge_chunks = int(meta["num_edge_chunks"])
        manifest = Manifest.load_if_present(root)
        self._sums: dict = manifest.files if manifest is not None else {}

    # ------------------------------------------------------------- builders
    @classmethod
    def from_graph(cls, graph: Graph, root: str, *,
                   chunk_nodes: int = 1 << 16,
                   chunk_edges: int = 1 << 16,
                   aio: "Optional[aio_mod.AioConfig]" = None) -> "OocGraph":
        """Spill an in-memory `Graph` to chunked tables under `root`.

        The in-memory edge columns are already in E_tst order (the Graph
        canonical sort); E_tts is produced by one (dst, src) lexsort — for
        graphs that never fit in memory the tables would instead be formed
        by `runs.external_sort`, which the build pipeline also exercises.
        """
        if chunk_nodes < 1 or chunk_edges < 1:
            raise ValueError("chunk sizes must be >= 1")
        os.makedirs(root, exist_ok=True)
        nodes = np.empty(graph.num_nodes, NODE_DTYPE)
        nodes["label"] = graph.node_labels
        n_node_chunks, sums = _write_chunked(os.path.join(root, "nodes"),
                                             nodes, chunk_nodes)
        tst = np.empty(graph.num_edges, TST_DTYPE)
        tst["src"], tst["elabel"], tst["dst"] = (graph.src, graph.elabel,
                                                 graph.dst)
        n_edge_chunks, s = _write_chunked(os.path.join(root, "edges_tst"),
                                          tst, chunk_edges)
        sums.update(s)
        order = graph.in_order()  # (dst, src) sort: the E_tts copy
        tts = np.empty(graph.num_edges, TTS_DTYPE)
        tts["dst"], tts["src"], tts["elabel"] = (graph.dst[order],
                                                 graph.src[order],
                                                 graph.elabel[order])
        _, s = _write_chunked(os.path.join(root, "edges_tts"), tts,
                              chunk_edges)
        sums.update(s)
        meta = dict(version=_FORMAT_VERSION, num_nodes=graph.num_nodes,
                    num_edges=graph.num_edges, chunk_nodes=chunk_nodes,
                    chunk_edges=chunk_edges, num_node_chunks=n_node_chunks,
                    num_edge_chunks=n_edge_chunks)
        with open(os.path.join(root, _META), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
            f.write("\n")
        Manifest(files=sums).write(root)
        return cls(root, aio=aio)

    # ------------------------------------------------------------------ IO
    def save(self, path: str) -> None:
        """Copy the table directory to `path` (must not exist)."""
        shutil.copytree(self.root, path)

    @classmethod
    def load(cls, path: str, *, verify: bool = True,
             stats: Optional[IOStats] = None) -> "OocGraph":
        """Open a saved table directory.  With ``verify`` (the default),
        every chunk is checked against the manifest's row counts and
        CRC-32s — a torn, truncated, or byte-flipped table raises
        `ChecksumError` here, never a silently wrong partition later."""
        g = cls(path)
        if verify:
            g.verify(stats=stats)
        return g

    def verify(self, *, stats: Optional[IOStats] = None) -> None:
        """Full checksum verification of every chunk against the
        manifest (one sequential read, charged to ``stats`` as a scan)."""
        if not self._sums:
            raise ChecksumError(
                f"no manifest for OocGraph at {self.root!r}; cannot "
                "verify integrity")
        expect = {f"nodes/chunk_{i:06d}.npy"
                  for i in range(self.num_node_chunks)}
        for t in ("edges_tst", "edges_tts"):
            expect |= {f"{t}/chunk_{i:06d}.npy"
                       for i in range(self.num_edge_chunks)}
        missing = expect - set(self._sums)
        if missing:
            raise ChecksumError(
                f"manifest at {self.root!r} is missing entries for "
                f"{sorted(missing)[:3]}...")
        Manifest(files=self._sums).verify(self.root, sorted(expect),
                                          stats=stats)

    # ------------------------------------------------------------ scanning
    def _iter_table(self, name: str, n_chunks: int,
                    stats: Optional[IOStats]) -> Iterator[np.ndarray]:
        def _read(path):
            # retry below the generator: a generator that has raised
            # cannot be re-driven, so transient-error recovery must wrap
            # the individual chunk load, not the scan
            fault_point("read", path)
            return np.array(np.load(path, mmap_mode="r"))

        def _raw():
            for i in range(n_chunks):
                path = os.path.join(self.root, name, f"chunk_{i:06d}.npy")
                with obs.span("table.scan", table=name, chunk=i) as sp:
                    chunk = with_retries(lambda: _read(path))
                    sp.set(rows=int(chunk.shape[0]))
                if stats is not None:
                    stats.count_scan(chunk.shape[0], chunk.nbytes)
                yield chunk

        if self.aio is None or not self.aio.enabled:
            yield from _raw()
            return
        reader = self.aio.prefetch(_raw())
        try:
            # re-yield instead of returning the reader so abandoning this
            # generator (GeneratorExit / GC) still joins the thread
            yield from reader
        finally:
            reader.close()

    def iter_nodes(self, stats: Optional[IOStats] = None
                   ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (base_node_id, label_chunk) over N_t in node-id order."""
        base = 0
        for chunk in self._iter_table("nodes", self.num_node_chunks, stats):
            yield base, chunk["label"]
            base += chunk.shape[0]

    def iter_edges_tst(self, stats: Optional[IOStats] = None
                       ) -> Iterator[np.ndarray]:
        """Scan E_tst: (src, elabel, dst) records sorted by (src,elabel,dst)."""
        return self._iter_table("edges_tst", self.num_edge_chunks, stats)

    def iter_edges_tts(self, stats: Optional[IOStats] = None
                       ) -> Iterator[np.ndarray]:
        """Scan E_tts: (dst, src, elabel) records sorted by (dst, src)."""
        return self._iter_table("edges_tts", self.num_edge_chunks, stats)

    # ----------------------------------------------------------- mutation
    def _chunk_paths(self, name: str, n_chunks: int) -> list:
        return [os.path.join(self.root, name, f"chunk_{i:06d}.npy")
                for i in range(n_chunks)]

    def _save_meta(self) -> None:
        meta = dict(version=_FORMAT_VERSION, num_nodes=self.num_nodes,
                    num_edges=self.num_edges, chunk_nodes=self.chunk_nodes,
                    chunk_edges=self.chunk_edges,
                    num_node_chunks=self.num_node_chunks,
                    num_edge_chunks=self.num_edge_chunks)
        with open(os.path.join(self.root, _META), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
            f.write("\n")
        # manifest last: it is the commit point of the whole mutation
        Manifest(files=self._sums).write(self.root)

    def _rewrite_table(self, name: str, chunks, chunk_rows: int):
        """Stream `chunks` into a fresh chunked dir (exact `chunk_rows`
        sized chunks via `rebuffer`), then swap it in whole.  The input
        generator is fully drained before the old directory goes away, so
        it may read from the table being replaced.  The old dir is
        renamed aside (not deleted) until the new one holds the live
        name, so the table is present under `name` at every instant
        except between the two renames."""
        with obs.span("table.rewrite", table=name) as sp:
            n_chunks, n_rows = self._rewrite_table_inner(name, chunks,
                                                         chunk_rows)
            sp.set(chunks=n_chunks, rows=n_rows)
        return n_chunks, n_rows

    def _rewrite_table_inner(self, name: str, chunks, chunk_rows: int):
        tmp = os.path.join(self.root, name + ".tmp")
        bak = os.path.join(self.root, name + ".bak")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(bak, ignore_errors=True)
        os.makedirs(tmp)
        n_chunks = n_rows = 0
        sums = {}
        # rebuffer emits fresh (or about-to-be-abandoned) arrays, so the
        # background saves own their chunks safely
        saver = aio_mod.BoundedSaver(self.aio)
        try:
            for chunk in rebuffer(chunks, chunk_rows):
                saver.save(os.path.join(tmp, f"chunk_{n_chunks:06d}.npy"),
                           chunk)
                # checksum from the bytes already in hand, before the
                # (possibly async) save — zero extra I/O
                sums[f"{name}/chunk_{n_chunks:06d}.npy"] = [
                    int(chunk.shape[0]), crc32_array(chunk)]
                n_chunks += 1
                n_rows += chunk.shape[0]
        finally:
            saver.drain()
        old = os.path.join(self.root, name)
        if os.path.exists(old):
            os.replace(old, bak)
        os.replace(tmp, old)
        shutil.rmtree(bak, ignore_errors=True)
        for rel in [r for r in self._sums if r.startswith(name + "/")]:
            del self._sums[rel]
        self._sums.update(sums)
        return n_chunks, n_rows

    @staticmethod
    def _neq_prev(rec: np.ndarray) -> np.ndarray:
        """rec[i] != rec[i-1] as an any-field-differs mask (i >= 1)."""
        neq = np.zeros(max(rec.shape[0] - 1, 0), dtype=bool)
        for f in rec.dtype.names:
            neq |= rec[f][1:] != rec[f][:-1]
        return neq

    def append_nodes(self, labels, *, stats: Optional[IOStats] = None
                     ) -> int:
        """Append isolated node rows to N_t; returns the first new id."""
        labels = np.atleast_1d(np.asarray(labels, dtype=np.int32))
        base = self.num_nodes
        if labels.shape[0] == 0:
            return base
        new = np.empty(labels.shape[0], NODE_DTYPE)
        new["label"] = labels

        def _stream():
            yield from self._iter_table("nodes", self.num_node_chunks,
                                        stats)
            yield new

        n_chunks, n_rows = self._rewrite_table("nodes", _stream(),
                                               self.chunk_nodes)
        self.num_nodes = n_rows
        self.num_node_chunks = n_chunks
        self._save_meta()
        return base

    def _merge_insert(self, name: str, keys, new_rec: np.ndarray,
                      n_chunks_old: int,
                      stats: Optional[IOStats]) -> Tuple[int, int]:
        """2-way emit-boundary merge of a sorted-unique batch into one
        sorted table dir, dropping records already present (the in-memory
        `Graph.from_edges` set semantics).  The existing table enters the
        shared kway core as `ChunkedColumn` sources — no materialization."""
        paths = self._chunk_paths(name, n_chunks_old)
        sources = [tuple(new_rec[k] for k in keys) + (new_rec,)]
        if paths:
            sources.insert(0, tuple(ChunkedColumn(paths, k) for k in keys)
                           + (ChunkedColumn(paths),))
        if stats is not None:
            stats.bump("merge_passes")
            stats.count_scan(self.num_edges,
                             self.num_edges * new_rec.dtype.itemsize)

        def _deduped():
            last = None
            for cols in merge_sorted_sources(sources,
                                             num_key_cols=len(keys),
                                             budget_rows=self.chunk_edges):
                rec = cols[-1]
                keep = np.ones(rec.shape[0], dtype=bool)
                keep[1:] = self._neq_prev(rec)
                if last is not None and rec.shape[0]:
                    keep[0] = any(rec[0][f] != last[f]
                                  for f in rec.dtype.names)
                last = rec[-1]
                out = rec[keep]
                if stats is not None:
                    stats.count_sort(out.shape[0], out.nbytes)
                yield out

        return self._rewrite_table(name, _deduped(), self.chunk_edges)

    def insert_edges(self, src, elabel, dst, *,
                     stats: Optional[IOStats] = None) -> int:
        """Merge new (src, elabel, dst) triples into both edge sort
        orders; exact duplicate triples are dropped (set semantics).
        Returns the number of edges actually added."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        elabel = np.atleast_1d(np.asarray(elabel, dtype=np.int32))
        if src.shape != dst.shape or src.shape != elabel.shape:
            raise ValueError("edge columns must have identical shapes")
        if src.shape[0] == 0:
            return 0
        # validate before touching anything: a rejected insert must leave
        # the tables untouched (mirrors Graph.__post_init__)
        if src.min() < 0 or src.max() >= self.num_nodes:
            raise ValueError("src out of range")
        if dst.min() < 0 or dst.max() >= self.num_nodes:
            raise ValueError("dst out of range")
        tst = np.empty(src.shape[0], TST_DTYPE)
        tst["src"], tst["elabel"], tst["dst"] = src, elabel, dst
        tts = np.empty(src.shape[0], TTS_DTYPE)
        tts["dst"], tts["src"], tts["elabel"] = dst, src, elabel
        # np.unique sorts structured records by field order == each
        # table's sort key, and drops within-batch duplicates
        tst, tts = np.unique(tst), np.unique(tts)
        n_old, chunks_old = self.num_edges, self.num_edge_chunks
        n_chunks, n_rows = self._merge_insert(
            "edges_tst", ("src", "elabel", "dst"), tst, chunks_old, stats)
        _, n_rows_tts = self._merge_insert(
            "edges_tts", ("dst", "src", "elabel"), tts, chunks_old, stats)
        assert n_rows == n_rows_tts, "edge sort orders diverged"
        self.num_edges = n_rows
        self.num_edge_chunks = n_chunks
        self._save_meta()
        return n_rows - n_old

    def delete_edges(self, src, elabel, dst, *,
                     stats: Optional[IOStats] = None) -> int:
        """Remove every edge matching one of the given triples (filtered
        rewrite of both sort orders).  Returns the number removed."""
        src = np.atleast_1d(np.asarray(src, dtype=np.int32))
        dst = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        elabel = np.atleast_1d(np.asarray(elabel, dtype=np.int32))
        if src.shape[0] == 0:
            return 0
        rm_tst = np.empty(src.shape[0], TST_DTYPE)
        rm_tst["src"], rm_tst["elabel"], rm_tst["dst"] = src, elabel, dst
        rm_tts = np.empty(src.shape[0], TTS_DTYPE)
        rm_tts["dst"], rm_tts["src"], rm_tts["elabel"] = dst, src, elabel

        def _filtered(chunks, rm):
            for chunk in chunks:
                yield chunk[~np.isin(chunk, rm)]

        n_chunks, n_rows = self._rewrite_table(
            "edges_tst", _filtered(self.iter_edges_tst(stats), rm_tst),
            self.chunk_edges)
        _, n_rows_tts = self._rewrite_table(
            "edges_tts", _filtered(self.iter_edges_tts(stats), rm_tts),
            self.chunk_edges)
        assert n_rows == n_rows_tts, "edge sort orders diverged"
        removed = self.num_edges - n_rows
        self.num_edges = n_rows
        self.num_edge_chunks = n_chunks
        self._save_meta()
        return removed

    def compact_rows(self, keep: np.ndarray, remap: np.ndarray, *,
                     stats: Optional[IOStats] = None) -> None:
        """Drop the node rows where ~keep and remap edge endpoints with
        the (monotone, so order-preserving) old->new id map."""
        keep = np.asarray(keep, dtype=bool)
        remap = np.asarray(remap, dtype=np.int64)

        def _nodes():
            base = 0
            for chunk in self._iter_table("nodes", self.num_node_chunks,
                                          stats):
                yield chunk[keep[base:base + chunk.shape[0]]]
                base += chunk.shape[0]

        def _edges(chunks, dtype):
            for chunk in chunks:
                part = chunk[keep[chunk["src"]] & keep[chunk["dst"]]]
                out = np.empty(part.shape[0], dtype)
                out["src"] = remap[part["src"]]
                out["dst"] = remap[part["dst"]]
                out["elabel"] = part["elabel"]
                yield out

        nn_chunks, nn_rows = self._rewrite_table("nodes", _nodes(),
                                                 self.chunk_nodes)
        ne_chunks, ne_rows = self._rewrite_table(
            "edges_tst", _edges(self.iter_edges_tst(stats), TST_DTYPE),
            self.chunk_edges)
        _, ne_rows_tts = self._rewrite_table(
            "edges_tts", _edges(self.iter_edges_tts(stats), TTS_DTYPE),
            self.chunk_edges)
        assert ne_rows == ne_rows_tts, "edge sort orders diverged"
        self.num_nodes, self.num_node_chunks = nn_rows, nn_chunks
        self.num_edges, self.num_edge_chunks = ne_rows, ne_chunks
        self._save_meta()

    # ---------------------------------------------------------- converters
    def to_memory(self) -> Graph:
        """Materialize as an in-memory `Graph` (inverse of `Graph.to_ooc`)."""
        labels = np.concatenate(
            [c for _, c in self.iter_nodes()]
        ) if self.num_nodes else np.empty(0, np.int32)
        if self.num_edges:
            tst = np.concatenate(list(self.iter_edges_tst()))
            src, elabel, dst = tst["src"], tst["elabel"], tst["dst"]
        else:
            src = dst = elabel = np.empty(0, np.int32)
        # E_tst is already the Graph canonical order; construct directly
        # (from_edges would re-sort and re-dedup identical data).
        return Graph(labels, src, dst, elabel)
