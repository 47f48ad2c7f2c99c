"""Fixed-slot batched quotient query evaluator: the `serve/engine.py`
wave idiom applied to structural queries, on the card.

The port of `repro.quotient.engine`.  Path queries are bucketed by
(level, hop count): every query in a bucket walks the same level ladder,
so a wave of up to ``max_batch`` of them advances one [B, n_blocks]
block mask a hop over the level's device-resident edge triples, and
makes ONE device->host transfer a wave (the final mask).  Padding slots
carry the WANT_NONE sentinel label, which matches no block.  Point
lookups never touch the device: they are host `searchsorted` over the
extent runs.

The hop is plain PyTorch, as the reference's is plain `jnp` (no Pallas
kernel): a gather of the target mask over the level's ``dst`` column, a
label compare, and a scatter of ones into the source blocks that hit.
Every write of that scatter stores the same value, so duplicate source
indices give one exact answer with no atomics; the lanes that miss write
into a sink column past the level's blocks.  The gather, compare and
scatter make [B, E_q] temporaries, so a hop runs over the edge axis in
tiles of at most `HOP_ELEMS` lanes a wave (the answer is the same for
any tiling).

The reference keys a compiled-program cache by the level shapes; eager
PyTorch has nothing to compile, so the port keeps no such cache.

Answers are bit-identical to `queries.eval_ref`: both compute the same
boolean masks and share `expand_blocks` for the mask -> node-id step.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..obs import tracer as obs
from .queries import (WANT_ALL, WANT_NONE, PointLookup, expand_blocks,
                      normalize_query, point_lookup)

HOP_ELEMS = 1 << 26  # [B, tile] lanes of one hop step (bounds temporaries)


def _init_mask(labels: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[B, n] endpoint mask: WANT_ALL slots match every block, real
    labels match their blocks, WANT_NONE (padding) matches none."""
    return (want[:, None] == WANT_ALL) | (labels[None, :] == want[:, None])


def _hop(mask_tgt: torch.Tensor, src: torch.Tensor, elabel: torch.Tensor,
         dst: torch.Tensor, want: torch.Tensor, *, n_src: int
         ) -> torch.Tensor:
    """One backward hop for a whole wave: block P survives for slot b iff
    some edge (P, want[b], Q) has mask_tgt[b, Q].  Returns a [B, n_src]
    view of a [B, n_src + 1] mask whose last column is the sink."""
    B = mask_tgt.shape[0]
    out = torch.zeros((B, n_src + 1), dtype=torch.bool,
                      device=mask_tgt.device)
    tile = max(1, HOP_ELEMS // max(B, 1))
    for e0 in range(0, src.shape[0], tile):
        s, el, d = src[e0:e0 + tile], elabel[e0:e0 + tile], dst[e0:e0 + tile]
        hit = torch.index_select(mask_tgt, 1, d) & (el[None, :]
                                                    == want[:, None])
        out.scatter_(1, torch.where(hit, s[None, :], n_src), True)
    return out[:, :n_src]


class _EpochView:
    """One epoch's immutable serving state: the host columns the answer
    path reads (duck-typing the `QuotientIndex` attributes that
    `expand_blocks` / `point_lookup` touch) plus the device tensors.
    `QuotientEngine.refresh` builds a fresh view and publishes it with
    one reference assignment: a query that pinned the previous view
    keeps reading a complete, never-mutated epoch while a patch lands."""

    __slots__ = ("epoch", "k", "counts", "labels", "runs",
                 "dev_levels", "dev_labels")

    def __init__(self, epoch, k, counts, labels, runs,
                 dev_levels, dev_labels):
        self.epoch = int(epoch)
        self.k = int(k)
        self.counts = counts
        self.labels = labels
        self.runs = runs
        self.dev_levels = dev_levels
        self.dev_labels = dev_labels


class QuotientEngine:
    """Serves one `QuotientIndex` snapshot on ``device`` (the card unless
    ``"cpu"`` is asked; it raises without one).  ``epoch`` names the
    snapshot every answer was computed against (the service bumps it
    atomically with the device-tensor swap).

    Admission is epoch-pinned: `query` captures the current `_EpochView`
    once and answers entirely from it, so queries admitted while a
    maintenance patch is being absorbed read the pre-patch epoch instead
    of stalling behind the patch; `refresh`/`rebind` are the only swap
    points, and the swap is a single reference assignment."""

    def __init__(self, index, *, max_batch: int = 64, device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device)
        self.index = index
        self.max_batch = int(max_batch)
        self.epoch = int(index.epoch)
        self.stats = dict(waves=0, hops=0, queries=0, point_lookups=0)
        self._dev_levels: Dict[int, tuple] = {}
        self._dev_labels: Dict[int, torch.Tensor] = {}
        self._view: _EpochView = None
        self.refresh()

    @property
    def device_bytes(self) -> int:
        """Bytes of the current epoch's device tensors."""
        view = self._view
        return sum(t.numel() * t.element_size()
                   for ts in view.dev_levels.values() for t in ts) + sum(
            t.numel() * t.element_size() for t in view.dev_labels.values())

    # ------------------------------------------------------------ snapshot
    def _upload(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, dtype)

    def refresh(self, levels=None) -> None:
        """(Re-)upload level edge triples and block labels; with
        ``levels`` only those (a patch's touched set), else all.  The
        caller patches the host index first (copy-on-write: pinned arrays
        are never scribbled on); this swap is the one atomic point where
        new queries start seeing the new epoch."""
        idx = self.index
        dev_levels = dict(self._dev_levels)
        dev_labels = dict(self._dev_labels)
        lvls = range(1, idx.k + 1) if levels is None else sorted(levels)
        for j in lvls:
            L = idx.levels[j]
            # int32 on disk; src/dst become int64 index tensors
            dev_levels[j] = (self._upload(L.src, torch.int64),
                             self._upload(L.elabel, torch.int32),
                             self._upload(L.dst, torch.int64))
        labs = range(idx.k + 1) if levels is None else sorted(
            set(levels) | {j - 1 for j in levels})
        for j in labs:
            if 0 <= j <= idx.k:
                dev_labels[j] = self._upload(idx.labels[j], torch.int32)
        if self.device.type == "cuda":
            # the new epoch's uploads complete before it is published, so
            # a query on any stream or thread that pins the view reads
            # finished tensors (a patch is rare; the wait is its uploads)
            torch.cuda.current_stream(self.device).synchronize()
        self._dev_levels = dev_levels
        self._dev_labels = dev_labels
        # the atomic swap: a single reference assignment under the GIL
        self._view = _EpochView(
            int(idx.epoch), idx.k, tuple(int(c) for c in idx.counts),
            list(idx.labels), list(idx.runs), dev_levels, dev_labels)
        self.epoch = int(idx.epoch)

    def rebind(self, index) -> None:
        """Point the engine at a replacement index (rematerialization):
        drop every device tensor and re-upload from scratch."""
        self.index = index
        self._dev_levels = {}
        self._dev_labels = {}
        self.refresh()

    # -------------------------------------------------------------- serve
    def query(self, queries: List) -> List:
        """Evaluate a batch of queries; answers keep input order.  Path
        queries return ascending node-id arrays, `PointLookup` returns a
        `PointAnswer`.  The whole batch is answered against the epoch
        current at admission (pinned once, here)."""
        view = self._view
        answers: List = [None] * len(queries)
        buckets: Dict[tuple, list] = {}
        for i, q in enumerate(queries):
            if isinstance(q, PointLookup):
                answers[i] = point_lookup(view, q.node, q.level)
                self.stats["point_lookups"] += 1
                continue
            labels, src_l, tgt_l, level = normalize_query(q, view.k)
            buckets.setdefault((level, len(labels)), []).append(
                (i, labels, src_l, tgt_l))
        for (j, m), items in sorted(buckets.items()):
            for w0 in range(0, len(items), self.max_batch):
                self._run_wave(view, j, m, items[w0:w0 + self.max_batch],
                               answers)
        return answers

    def _run_wave(self, view: _EpochView, j: int, m: int, wave: list,
                  answers: list) -> None:
        B = self.max_batch
        with obs.span("quotient.query_wave", level=j, hops=m,
                      batch=len(wave), epoch=view.epoch):
            # row 0: the endpoint want; row 1 + t: hop t's edge label
            want = np.full((m + 1, B), WANT_NONE, dtype=np.int32)
            for s, (_, labels, _, tgt_l) in enumerate(wave):
                want[0, s] = WANT_ALL if tgt_l is None else tgt_l
                want[1:, s] = labels
            # the device part, ended by the transfer's wait: its span is
            # the wave's mask time on the host clock
            with obs.span("quotient.wave_mask", level=j, hops=m):
                want_d = self._upload(want, torch.int32)
                mask = _init_mask(view.dev_labels[j - m], want_d[0])
                for t in range(m - 1, -1, -1):
                    lev = j - t
                    src, el, dst = view.dev_levels[lev]
                    mask = _hop(mask, src, el, dst, want_d[1 + t],
                                n_src=view.counts[lev])
                    self.stats["hops"] += 1
                # the wave's one device->host transfer
                host = mask.cpu().numpy()
            self.stats["waves"] += 1
            for s, (i, _, src_l, _) in enumerate(wave):
                answers[i] = expand_blocks(view, j, host[s], src_l)
                self.stats["queries"] += 1
