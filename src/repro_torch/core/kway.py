"""The k-way emit-boundary merge core (paper §3.1's `sort` inner loop).

Every external-memory component of this repo — the run merger of
`repro_torch.exmem.runs`, the spill-run compaction of
`core.sig_store.SpillableSigStore`, and the on-disk table updates of
`repro_torch.exmem.tables.OocGraph` — needs the same primitive: merge several
individually-sorted sources under a bounded memory budget.  This module is
that primitive, implemented exactly once and parameterized over a
lexicographic key (one or more key columns) plus arbitrary payload columns
that ride along.

The algorithm is the *emit boundary* merge:

  * every live source buffers a block of ``budget_rows // k`` rows (so
    total resident memory is one budget regardless of fan-in);
  * the emit boundary is the smallest last-buffered key among sources that
    still have unbuffered rows — every buffered row whose key is <= the
    boundary is globally in final position (nothing still on disk can
    precede it);
  * those rows are concatenated, sorted once in memory, and emitted.
    Sources whose remaining rows are all buffered impose no bound.

Sources are tuples of parallel 1-D "columns"; a column is anything
sliceable that yields numpy arrays (ndarray, ``np.memmap``, a structured
array, or a lazy view such as `exmem.tables.ChunkedColumn`).  The leading
``num_key_cols`` columns form the key, most significant first; the whole
structured record array itself can double as a payload column, which is
how the record-file merger reuses this core without reshaping its data.

The port's own copy of `repro.core.kway` (numpy only).
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def _leq_bound(key_bufs: Sequence[np.ndarray], bound: tuple) -> np.ndarray:
    """Vectorized lexicographic ``key <= bound`` mask over parallel
    key-column buffers."""
    k0 = key_bufs[0]
    if len(key_bufs) == 1:
        return k0 <= bound[0]
    return (k0 < bound[0]) | ((k0 == bound[0])
                              & _leq_bound(key_bufs[1:], bound[1:]))


def merge_sorted_sources(sources, num_key_cols: int = 1, *,
                         budget_rows: int = 1 << 16
                         ) -> Iterator[tuple]:
    """Bounded-memory k-way merge of pre-sorted column sources.

    sources: sequence of column tuples/lists; within one source all columns
    are parallel and equally long, and the source is sorted by the
    lexicographic key formed by its first ``num_key_cols`` columns (most
    significant first).  Every source must share the same column layout.

    Yields tuples of np.ndarray columns (same layout) in globally sorted
    key order.  Chunks hold at most ``budget_rows`` rows plus up to one
    buffered block per source (the same overshoot the historical mergers
    had); callers that need exact sizes re-chunk downstream.
    """
    if num_key_cols < 1:
        raise ValueError("num_key_cols must be >= 1")
    srcs = [list(cols) for cols in sources if cols[0].shape[0]]
    if not srcs:
        return
    ncols = len(srcs[0])
    if any(len(cols) != ncols for cols in srcs):
        raise ValueError("all sources must share one column layout")
    lengths = [int(cols[0].shape[0]) for cols in srcs]
    block = max(budget_rows // len(srcs), 1)
    cur = [0] * len(srcs)
    buf: list = [None] * len(srcs)
    while True:
        active = []
        for i, cols in enumerate(srcs):
            if buf[i] is None or buf[i][0].shape[0] == 0:
                if cur[i] < lengths[i]:
                    sl = slice(cur[i], cur[i] + block)
                    buf[i] = [np.array(c[sl]) for c in cols]
                    cur[i] += buf[i][0].shape[0]
                else:
                    buf[i] = None
            if buf[i] is not None:
                active.append(i)
        if not active:
            return
        # Emit boundary: min last-buffered key among sources with rows
        # still on disk; fully-buffered sources impose no bound.
        bound = None
        for i in active:
            if cur[i] < lengths[i]:
                last = tuple(buf[i][c][-1] for c in range(num_key_cols))
                if bound is None or last < bound:
                    bound = last
        takes: list = [[] for _ in range(ncols)]
        for i in active:
            b = buf[i]
            if bound is None:
                cnt = int(b[0].shape[0])
            elif num_key_cols == 1:
                # single sorted key column: binary search beats the mask
                cnt = int(np.searchsorted(b[0], bound[0], side="right"))
            else:
                cnt = int(np.count_nonzero(
                    _leq_bound(b[:num_key_cols], bound)))
            if cnt:
                for c in range(ncols):
                    takes[c].append(b[c][:cnt])
                    b[c] = b[c][cnt:]
        out = [np.concatenate(t) for t in takes]
        order = np.lexsort(tuple(out[c]
                                 for c in reversed(range(num_key_cols))))
        yield tuple(c[order] for c in out)
