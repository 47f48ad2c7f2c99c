"""External merge-sort over fixed-size on-disk runs (paper §3.1).

The paper's algorithms are built from exactly two I/O primitives over
disk-resident tables: `scan(X)` (stream a table once, sequentially) and
`sort(X)` (external merge-sort: form sorted runs of memory size, then
k-way merge).  This module is the generic implementation of `sort`:

  * records are numpy *structured arrays*; a run is one ``.npy`` file of
    records sorted by a lexicographic key (a tuple of field names, most
    significant first).  Runs are read back memory-mapped, so the merge
    touches only the pages of the blocks it buffers.
  * `sort_to_runs` forms the runs: each incoming chunk (the memory budget)
    is sorted in RAM with one `np.lexsort` and written out.
  * `merge_runs` is the bounded-memory k-way merge of the runs.  The
    emit-boundary merge loop itself lives in `repro_torch.core.kway` — the one
    merge core shared with `SpillableSigStore`'s spill-run compaction and
    `OocGraph`'s on-disk table updates; this module's wrapper only maps
    record files onto (key columns + record payload) sources and does the
    I/O accounting.
  * `external_sort` composes the two, collapsing run fan-in above
    ``fan_in`` with intermediate merge passes (multi-pass external sort),
    and yields the fully sorted stream chunk by chunk.
  * `rebuffer` re-chunks a record stream to a fixed row budget, so
    producers that emit sub-budget slivers (sparse merge joins on N >> E
    graphs) still form full-budget runs.

`IOStats` mirrors the paper's cost accounting: `sort_cost` counts records
pushed through sort passes (run formation + every merge pass + signature
ranking), `scan_cost` counts records streamed sequentially, so a pipeline
obeying `O(k·sort(|E_t|) + k·scan(|N_t|) + sort(|N_t|))` shows counters
linear in k.  Byte counters track the actual file traffic.

The port's own copy of `repro.exmem.runs` (numpy only).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ..core.kway import merge_sorted_sources
from ..obs import tracer as obs

from . import aio as aio_mod


@dataclasses.dataclass
class IOStats:
    """Record/byte counters for the paper's sort/scan cost model.

    With the async pipeline (`exmem.aio`) a stream's producer may charge
    counters from its reader thread while the consumer charges its own,
    so the increments are guarded by a lock — the *totals* stay exactly
    equal with the pipeline on or off (every record is counted once, by
    whichever thread runs the counting code)."""

    sort_cost: int = 0      # records pushed through external-sort passes
    scan_cost: int = 0      # records streamed sequentially
    sort_bytes: int = 0
    scan_bytes: int = 0
    runs_written: int = 0
    merge_passes: int = 0
    spills: int = 0         # SpillableSigStore runs flushed to disk

    def __post_init__(self):
        self._lock = threading.Lock()

    def count_sort(self, records: int, nbytes: int) -> None:
        with self._lock:
            self.sort_cost += int(records)
            self.sort_bytes += int(nbytes)

    def count_scan(self, records: int, nbytes: int) -> None:
        with self._lock:
            self.scan_cost += int(records)
            self.scan_bytes += int(nbytes)

    def bump(self, field: str, n: int = 1) -> None:
        """Locked increment for the event counters (runs_written,
        merge_passes, spills) — like the record counters, these may be
        charged from a pipeline producer thread."""
        with self._lock:
            setattr(self, field, getattr(self, field) + int(n))

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def as_dict(self) -> dict:
        """Uniform stats surface (same contract as `AioStats.as_dict` /
        `MaintenanceReport.as_dict`)."""
        return self.to_dict()

    def merge(self, other) -> "IOStats":
        """Fold another IOStats (or its `as_dict()`) into this one, in
        place: every counter adds."""
        d = other.as_dict() if hasattr(other, "as_dict") else dict(other)
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name,
                        getattr(self, f.name) + int(d.get(f.name, 0)))
        return self

    def restore(self, d: dict) -> None:
        """Reset every counter to a checkpointed `to_dict` snapshot, so a
        resumed build's accounting continues instead of restarting."""
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name, int(d.get(f.name, 0)))


def make_records(cols: dict) -> np.ndarray:
    """Pack parallel 1-D columns into one structured record array."""
    names = list(cols)
    arrays = [np.asarray(cols[n]) for n in names]
    n = arrays[0].shape[0]
    if any(a.shape != (n,) for a in arrays):
        raise ValueError("columns must be parallel 1-D arrays")
    rec = np.empty(n, dtype=np.dtype([(nm, a.dtype)
                                      for nm, a in zip(names, arrays)]))
    for nm, a in zip(names, arrays):
        rec[nm] = a
    return rec


def lexsort_records(rec: np.ndarray, keys: Sequence[str]) -> np.ndarray:
    """Sort records by the lexicographic key (most significant first)."""
    order = np.lexsort(tuple(rec[k] for k in reversed(keys)))
    return rec[order]


def rebuffer(chunks: Iterable[np.ndarray], rows: int) -> Iterator[np.ndarray]:
    """Re-chunk a record stream into exactly ``rows``-sized chunks (the
    final chunk may be shorter).  Producers like the sparse E_tts ⋈ pid
    merge join emit one sliver per pid window — on N >> E graphs far below
    the memory budget — and feeding those to `sort_to_runs` directly
    inflates the run count (and so the merge passes).  Buffering up to the
    budget first keeps every run full-sized."""
    if rows < 1:
        raise ValueError("rows must be >= 1")
    buf: list = []
    have = 0
    for chunk in chunks:
        if chunk.shape[0] == 0:
            continue
        buf.append(chunk)
        have += chunk.shape[0]
        while have >= rows:
            cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield cat[:rows]
            rest = cat[rows:]
            buf = [rest] if rest.shape[0] else []
            have = int(rest.shape[0])
    if have:
        yield np.concatenate(buf) if len(buf) > 1 else buf[0]


def sort_to_runs(chunks: Iterable[np.ndarray], keys: Sequence[str],
                 tmpdir: str, *, stats: Optional[IOStats] = None,
                 prefix: str = "run",
                 aio: "Optional[aio_mod.AioConfig]" = None,
                 obs_attrs: Optional[dict] = None) -> list:
    """Run-formation pass: lexsort each chunk in memory, write one `.npy`
    run per chunk. Returns the run paths (empty chunks are dropped).

    With ``aio`` enabled each run save lands on the shared executor, so
    run ``i`` streams to disk while chunk ``i+1`` is being lexsorted —
    the number of outstanding saves is bounded by ``aio.max_pending``.
    Every save is atomic (temp file + rename) and fully drained before
    the paths are returned."""
    os.makedirs(tmpdir, exist_ok=True)
    paths = []
    saver = aio_mod.BoundedSaver(aio)
    try:
        for i, chunk in enumerate(chunks):
            if chunk.shape[0] == 0:
                continue
            with obs.span("sort.run_formation", **(obs_attrs or {})) as sp:
                rec = lexsort_records(chunk, keys)
                path = os.path.join(tmpdir, f"{prefix}_{i:06d}.npy")
                saver.save(path, rec)
                sp.set(rows=int(rec.shape[0]))
            paths.append(path)
            if stats is not None:
                stats.count_sort(rec.shape[0], rec.nbytes)
                stats.bump("runs_written")
    finally:
        saver.drain()
    return paths


def merge_runs(paths: Sequence[str], keys: Sequence[str], *,
               budget_rows: int = 1 << 16,
               stats: Optional[IOStats] = None,
               aio: "Optional[aio_mod.AioConfig]" = None,
               obs_attrs: Optional[dict] = None
               ) -> Iterator[np.ndarray]:
    """Bounded-memory k-way merge of sorted runs; yields sorted chunks of at
    most ``budget_rows`` records. Total resident memory is one block of
    ``budget_rows // k`` records per live run (runs are memory-mapped).

    The merge loop is `repro_torch.core.kway.merge_sorted_sources`; each run file
    maps onto a source of (key field views..., whole record array) columns,
    so the records ride along their own key as the payload column.  With
    ``aio`` enabled each run is wrapped in a `ReadaheadArray`, so every
    source's *next* input block is being read while the current one is
    merged (one extra block per run resident — the double buffer)."""
    arrs = [np.load(p, mmap_mode="r") for p in paths]
    arrs = [a for a in arrs if a.shape[0]]
    if not arrs:
        return
    if stats is not None:
        stats.bump("merge_passes")
    if len(arrs) == 1:
        # degenerate merge: one run is already sorted, stream it (scan)
        a = arrs[0]
        for s in range(0, a.shape[0], budget_rows):
            chunk = np.array(a[s:s + budget_rows])
            if stats is not None:
                stats.count_scan(chunk.shape[0], chunk.nbytes)
            yield chunk
        return
    if aio is not None and aio.enabled:
        arrs = [aio.readahead(a) for a in arrs]
    obs.event("sort.merge_pass", runs=len(arrs), **(obs_attrs or {}))
    sources = [tuple(a[k] for k in keys) + (a,) for a in arrs]
    it = merge_sorted_sources(sources, num_key_cols=len(keys),
                              budget_rows=budget_rows)
    while True:
        # span per merged chunk, closed before the yield (spans must not
        # stay open across a generator suspension)
        with obs.span("sort.merge_chunk", **(obs_attrs or {})) as sp:
            cols = next(it, None)
            if cols is None:
                break
            out = cols[-1]
            sp.set(rows=int(out.shape[0]))
        if stats is not None:
            stats.count_sort(out.shape[0], out.nbytes)
        yield out


def _merge_to_file(paths: Sequence[str], keys: Sequence[str], out_path: str,
                   *, budget_rows: int, stats: Optional[IOStats],
                   aio: "Optional[aio_mod.AioConfig]" = None,
                   obs_attrs: Optional[dict] = None) -> str:
    """Collapse several runs into one: the readahead merge feeds a
    `StreamingWriter` through a `Pipeline` — reads, merge compute, and
    the output write all overlap (when ``aio`` is enabled)."""
    total = sum(int(np.load(p, mmap_mode="r").shape[0]) for p in paths)
    dtype = np.load(paths[0], mmap_mode="r").dtype
    # intermediate merge outputs are scratch (rebuilt from the tables on
    # any failure), so skip the per-file fsync
    writer = (aio.writer(out_path, dtype, total, fsync=False)
              if aio is not None
              else aio_mod.StreamingWriter(out_path, dtype, total,
                                           threaded=False, fsync=False))
    with obs.span("sort.merge_to_file", fan_in=len(paths), rows=total,
                  **(obs_attrs or {})):
        with writer:
            aio_mod.Pipeline(
                merge_runs(paths, keys, budget_rows=budget_rows, stats=stats,
                           aio=aio, obs_attrs=obs_attrs),
                writer=writer).run()
    for p in paths:
        os.remove(p)
    if stats is not None:
        stats.bump("runs_written")
    return out_path


def external_sort(chunks: Iterable[np.ndarray], keys: Sequence[str],
                  tmpdir: str, *, budget_rows: int = 1 << 16,
                  fan_in: int = 16, stats: Optional[IOStats] = None,
                  aio: "Optional[aio_mod.AioConfig]" = None,
                  obs_attrs: Optional[dict] = None
                  ) -> Iterator[np.ndarray]:
    """Full external sort: run formation, intermediate merge passes while
    the fan-in exceeds ``fan_in``, then the final streaming merge.  The
    optional ``aio`` pipeline threads every pass (async run saves,
    readahead merge inputs, streamed intermediate writes) without
    changing a single byte of any run or the `IOStats` accounting.
    ``obs_attrs`` (e.g. ``{"level": j}``) rides on every span this sort
    emits, so phases aggregate per level."""
    paths = sort_to_runs(chunks, keys, tmpdir, stats=stats, aio=aio,
                         obs_attrs=obs_attrs)
    level = 0
    while len(paths) > fan_in:
        merged = []
        for gi in range(0, len(paths), fan_in):
            group = paths[gi:gi + fan_in]
            out = os.path.join(tmpdir, f"merge_{level}_{gi:06d}.npy")
            merged.append(_merge_to_file(group, keys, out,
                                         budget_rows=budget_rows,
                                         stats=stats, aio=aio,
                                         obs_attrs=obs_attrs))
        paths = merged
        level += 1
    yield from merge_runs(paths, keys, budget_rows=budget_rows, stats=stats,
                          aio=aio, obs_attrs=obs_attrs)
