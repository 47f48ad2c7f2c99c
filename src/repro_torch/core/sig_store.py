"""Array-backed signature store S (paper §3.2, sorted-file implementation).

The port's own copy of `repro.core.sig_store`.  `SigStore` is one
sorted ``uint64`` key column (the fused ``hi << 32 | lo`` signature hash)
plus a parallel ``int64`` pid column, with the paper's bulk operations
(lookup = ``np.searchsorted``, insert = sort + merge, get_or_assign =
Algorithm 4 lines 13-17 over a whole frontier).  Level 0 keys the store by
``uint64(node_label)`` (hi lane 0).

It is host-side numpy: the build extracts each level's store from the
(hi, lo) lanes it already computed.  ``SpillableSigStore`` bounds resident
memory for the out-of-core build (`repro_torch.exmem`): past
``spill_threshold`` entries the sorted run is flushed to disk and probed
there — the paper's S as an actual sorted *file*.
"""
from __future__ import annotations

import os

import numpy as np

from .integrity import ChecksumError, crc32_array, crc32_update
from .kway import merge_sorted_sources
from ..obs import tracer as obs


_U64 = np.uint64
_SHIFT = np.uint64(32)


def fuse_key(hi, lo) -> np.ndarray:
    """Fuse (hi, lo) u32 hash lanes into the store's sortable u64 key."""
    hi = np.asarray(hi).astype(np.uint32, copy=False)
    lo = np.asarray(lo).astype(np.uint32, copy=False)
    return (hi.astype(_U64) << _SHIFT) | lo.astype(_U64)


def label_key(labels) -> np.ndarray:
    """Level-0 key: the raw node label in the lo lane (hi lane zero)."""
    return np.asarray(labels).astype(np.uint32, copy=False).astype(_U64)


def split_key(keys) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `fuse_key`: u64 keys back to (hi, lo) u32 lanes.

    A device mirror keeps the two lanes as parallel columns, so the sorted
    u64 column round-trips through this split (lexicographic (hi, lo)
    order == u64 order).
    """
    keys = np.asarray(keys, dtype=_U64)
    return (keys >> _SHIFT).astype(np.uint32), keys.astype(np.uint32)


_FLIP = np.uint64(1 << 63)


def keys_to_lanes(keys) -> np.ndarray:
    """u64 store keys as int64 whose signed order is the keys' order
    (``key ^ 2^63``; the all-ones key becomes INT64_MAX): the form in
    which a device tensor holds them."""
    return (np.asarray(keys, dtype=_U64) ^ _FLIP).view(np.int64)


def lanes_to_keys(lanes) -> np.ndarray:
    """Inverse of `keys_to_lanes`."""
    return np.asarray(lanes, dtype=np.int64).view(_U64) ^ _FLIP


class SigStore:
    """Sorted (key u64, pid int64) columns; all ops are bulk array ops."""

    __slots__ = ("keys", "pids")

    def __init__(self, keys: np.ndarray, pids: np.ndarray, *,
                 presorted: bool = False):
        keys = np.asarray(keys, dtype=_U64)
        pids = np.asarray(pids, dtype=np.int64)
        if keys.shape != pids.shape:
            raise ValueError("keys and pids must be parallel 1-D arrays")
        if not presorted:
            keys, first = np.unique(keys, return_index=True)
            pids = pids[first]
        self.keys = keys
        self.pids = pids

    # ------------------------------------------------------------ builders
    @classmethod
    def empty(cls) -> "SigStore":
        return cls(np.empty(0, _U64), np.empty(0, np.int64), presorted=True)

    @classmethod
    def from_hash_pairs(cls, hi, lo, pids) -> "SigStore":
        """Build from per-node (hi, lo, pid) arrays; duplicates collapse
        (all nodes with one signature share a pid by construction)."""
        return cls(fuse_key(hi, lo), pids)

    @classmethod
    def from_labels(cls, labels, pids) -> "SigStore":
        return cls(label_key(labels), pids)

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def __contains__(self, key) -> bool:
        # via self.lookup so subclasses that store keys elsewhere (the
        # spillable store's disk runs) answer correctly too
        _, found = self.lookup(np.asarray([key], dtype=_U64))
        return bool(found[0])

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Bulk lookup. Returns (pids int64, found bool); missing -> -1."""
        keys = np.asarray(keys, dtype=_U64)
        n_mem = int(self.keys.shape[0])  # resident run only (see Spillable)
        idx = np.searchsorted(self.keys, keys)
        idx_c = np.minimum(idx, max(n_mem - 1, 0))
        found = (np.zeros(keys.shape, bool) if n_mem == 0
                 else self.keys[idx_c] == keys)
        out = np.where(found, self.pids[idx_c] if n_mem else -1, -1)
        return out.astype(np.int64, copy=False), found

    def get(self, key, default=None):
        pid, found = self.lookup(np.asarray([key], dtype=_U64))
        return int(pid[0]) if found[0] else default

    # ------------------------------------------------------------- updates
    def insert(self, keys, pids) -> None:
        """Merge (keys, pids) into the store. Existing keys keep their pid
        (the store is an injective signature -> pId map; re-inserting an
        existing signature with a different pid would be a logic error)."""
        keys = np.asarray(keys, dtype=_U64)
        pids = np.asarray(pids, dtype=np.int64)
        if keys.size == 0:
            return
        ukeys, first = np.unique(keys, return_index=True)
        upids = pids[first]
        _, found = self.lookup(ukeys)
        novel = ~found
        if not novel.any():
            return
        merged_keys = np.concatenate([self.keys, ukeys[novel]])
        merged_pids = np.concatenate([self.pids, upids[novel]])
        order = np.argsort(merged_keys, kind="stable")
        self.keys = merged_keys[order]
        self.pids = merged_pids[order]

    def get_or_assign(self, keys, next_pid: int) -> tuple[np.ndarray, int]:
        """Resolve every key to a pid, minting fresh pids for novel keys.

        New pids are assigned in order of first occurrence in `keys`
        (matching what a sequential dict walk over the frontier would do),
        starting at `next_pid`. Returns (pids int64 [len(keys)], next_pid').
        """
        keys = np.asarray(keys, dtype=_U64)
        out, found = self.lookup(keys)
        if found.all():
            return out, next_pid
        miss = ~found
        mkeys = keys[miss]
        ukeys, first, inv = np.unique(mkeys, return_index=True,
                                      return_inverse=True)
        # rank unique novel keys by first appearance in the probe order
        appearance = np.argsort(np.argsort(first, kind="stable"),
                                kind="stable")
        new_pids = np.int64(next_pid) + appearance
        out[miss] = new_pids[inv]
        merged_keys = np.concatenate([self.keys, ukeys])
        merged_pids = np.concatenate([self.pids, new_pids])
        order = np.argsort(merged_keys, kind="stable")
        self.keys = merged_keys[order]
        self.pids = merged_pids[order]
        return out, next_pid + int(ukeys.shape[0])

    # --------------------------------------------------------------- misc
    def to_dict(self) -> dict:
        """Materialize as {int key: int pid} (tests / debugging only)."""
        return {int(k): int(p) for k, p in zip(self.keys.tolist(),
                                               self.pids.tolist())}

    def slice_copy(self) -> "SigStore":
        return SigStore(self.keys.copy(), self.pids.copy(), presorted=True)


class SpillableSigStore(SigStore):
    """`SigStore` with bounded resident memory (paper §3.2: S is a sorted
    *file*, not an in-RAM map).

    The in-memory sorted run behaves exactly like `SigStore`; once it grows
    past ``spill_threshold`` entries it is flushed to a sorted on-disk run
    (two parallel ``.npy`` files, keys u64 + pids i64).  Lookups probe the
    resident run first, then `np.searchsorted` each memory-mapped disk run
    — O(log) page touches per run.  When more than ``max_runs`` runs
    accumulate they are k-way merged back into a single run with a bounded
    block budget, the same sort/merge discipline as `exmem.runs`.  A key
    lives in exactly one place (inserts check membership first), so probe
    order never changes an answer.

    ``io`` (an `exmem.runs.IOStats`) charges spills and merges to
    `sort_cost`, mirroring the paper's accounting of maintaining S.

    ``aio`` (duck-typed `exmem.aio.AioConfig`; this module never imports
    the exmem layer) runs spill writes on the pipeline executor, so a
    flush overlaps the fold that triggered it; a probe that needs a
    still-in-flight run waits for exactly that file.  ``mmap_cache``
    bounds the open-memmap LRU over spill runs: a probe window re-uses
    the files it just touched instead of re-opening every run, while a
    store with hundreds of runs keeps O(mmap_cache) descriptors, not
    O(runs).
    """

    __slots__ = ("spill_threshold", "max_runs", "spill_dir", "io", "aio",
                 "mmap_cache", "_runs", "_run_seq", "_owns_dir", "_mmaps",
                 "_pending", "_sums", "_verified")

    def __init__(self, spill_threshold: int = 1 << 20, *,
                 spill_dir: "str | None" = None, max_runs: int = 8,
                 io=None, aio=None, mmap_cache: "int | None" = None):
        super().__init__(np.empty(0, _U64), np.empty(0, np.int64),
                         presorted=True)
        if spill_threshold < 1:
            raise ValueError("spill_threshold must be >= 1")
        if max_runs < 2:
            # with a single victim the tiered merge could never reduce the
            # run count, so fan-out would grow without bound
            raise ValueError("max_runs must be >= 2")
        if mmap_cache is None:
            # a lookup can cycle through every run's keys+pids files, so
            # the steady-state working set is 2*max_runs open maps (the
            # tiered merge keeps the run count near max_runs); default to
            # holding a full probe cycle, else every probe would reopen
            # every run (0% hit rate under cyclic eviction)
            mmap_cache = 2 * int(max_runs) + 2
        if mmap_cache < 2:
            # a probe touches a run's keys and pids files together; a
            # 1-entry cache would thrash within a single window
            raise ValueError("mmap_cache must be >= 2")
        self.spill_threshold = int(spill_threshold)
        self.max_runs = int(max_runs)
        self.io = io
        self.aio = aio
        self.mmap_cache = int(mmap_cache)
        self._owns_dir = spill_dir is None
        if spill_dir is None:
            import tempfile
            spill_dir = tempfile.mkdtemp(prefix="sigstore-spill-")
        os.makedirs(spill_dir, exist_ok=True)
        self.spill_dir = spill_dir
        self._runs = []      # list of (keys_path, pids_path, length)
        self._run_seq = 0
        from collections import OrderedDict
        self._mmaps = OrderedDict()  # path -> memmap, LRU-bounded
        self._pending = {}   # path -> in-flight async spill write
        self._sums = {}      # path -> crc32 of run data, recorded at spill
        self._verified = set()  # paths whose checksum has been checked

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return int(self.keys.shape[0]) + sum(ln for _, _, ln in self._runs)

    @property
    def num_spilled_runs(self) -> int:
        return len(self._runs)

    def _wait_pending(self, path: str) -> None:
        fut = self._pending.pop(path, None)
        if fut is not None:
            fut.result()

    def _mmap(self, path: str) -> np.ndarray:
        """LRU-cached memmap of a run file (runs are immutable until their
        file is deleted by a merge, which also evicts the cache entry).
        The cache holds at most ``mmap_cache`` open files; an async spill
        still in flight for ``path`` is awaited before the open."""
        mm = self._mmaps.get(path)
        if mm is not None:
            self._mmaps.move_to_end(path)
            return mm
        self._wait_pending(path)
        try:
            mm = np.load(path, mmap_mode="r")
        except (OSError, ValueError, EOFError) as exc:
            raise ChecksumError(
                f"unreadable spill run {path!r}: {exc}") from exc
        # first open of a run verifies its recorded checksum (one full
        # read); later cache misses re-open without re-verifying
        if path not in self._verified:
            expect = self._sums.get(path)
            if expect is not None and crc32_array(np.asarray(mm)) != expect:
                raise ChecksumError(
                    f"checksum mismatch in spill run {path!r}")
            self._verified.add(path)
        self._mmaps[path] = mm
        while len(self._mmaps) > self.mmap_cache:
            self._mmaps.popitem(last=False)
        return mm

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys, dtype=_U64)
        with obs.span("store.probe", keys=int(keys.shape[0]),
                      runs=len(self._runs)):
            out, found = super().lookup(keys)
            for kp, pp, ln in self._runs:
                if found.all():
                    break
                rk = self._mmap(kp)
                miss = np.flatnonzero(~found)
                idx = np.searchsorted(rk, keys[miss])
                idx_c = np.minimum(idx, ln - 1)
                hit = np.asarray(rk[idx_c]) == keys[miss]
                if hit.any():
                    rp = self._mmap(pp)
                    out[miss[hit]] = rp[idx_c[hit]]
                    found[miss[hit]] = True
        return out, found

    # ------------------------------------------------------------- updates
    def insert(self, keys, pids) -> None:
        super().insert(keys, pids)
        self._maybe_spill()

    def get_or_assign(self, keys, next_pid: int) -> tuple[np.ndarray, int]:
        with obs.span("store.resolve") as sp:
            out, nxt = super().get_or_assign(keys, next_pid)
            sp.set(keys=int(np.asarray(keys).shape[0]),
                   minted=int(nxt - next_pid))
            self._maybe_spill()
        return out, nxt

    # ------------------------------------------------------------ spilling
    def _maybe_spill(self) -> None:
        if self.keys.shape[0] > self.spill_threshold:
            self._spill()
        if len(self._runs) > self.max_runs:
            self._merge_runs()

    def _spill(self) -> None:
        n = int(self.keys.shape[0])
        if n == 0:
            return
        with obs.span("store.spill", rows=n, runs=len(self._runs)):
            self._spill_inner(n)

    def _spill_inner(self, n: int) -> None:
        kp = os.path.join(self.spill_dir, f"run_{self._run_seq:06d}.keys.npy")
        pp = os.path.join(self.spill_dir, f"run_{self._run_seq:06d}.pids.npy")
        # checksums from the arrays still in hand, before the save
        self._sums[kp] = crc32_array(self.keys)
        self._sums[pp] = crc32_array(self.pids)
        # just written from these very bytes: verification is for runs
        # adopted from a snapshot, not ones this process produced
        self._verified.update((kp, pp))
        if self.aio is not None and getattr(self.aio, "enabled", False):
            # the resident arrays are replaced (never mutated) below, so
            # the background save owns them; probes against this run wait
            # on the future in _mmap before opening the file
            self._pending[kp] = self.aio.save_async(kp, self.keys)
            self._pending[pp] = self.aio.save_async(pp, self.pids)
        else:
            np.save(kp, self.keys)
            np.save(pp, self.pids)
        self._runs.append((kp, pp, n))
        self._run_seq += 1
        if self.io is not None:
            self.io.bump("spills")
            self.io.count_sort(n, self.keys.nbytes + self.pids.nbytes)
        self.keys = np.empty(0, _U64)
        self.pids = np.empty(0, np.int64)

    def _merge_runs(self, budget_rows: int = 1 << 16) -> None:
        """Size-tiered merge: collapse the `max_runs` *smallest* runs into
        one (bounded block buffers per run), leaving larger runs alone —
        each key is rewritten O(log n/threshold) times total instead of on
        every merge cycle (the LSM-style amplification bound).

        Keys are globally unique across runs, so the merged run is strictly
        sorted and pid payloads ride along unchanged.

        The merge loop is `core.kway.merge_sorted_sources` over (keys,
        pids) column pairs — the same emit-boundary core `exmem.runs` uses
        for record files.  The runs stay as two parallel *contiguous*
        files (not structured records) so `np.searchsorted` probes touch
        O(log) pages instead of copying a strided column.
        """
        with obs.span("store.merge", fan_in=self.max_runs,
                      runs=len(self._runs)):
            self._merge_runs_inner(budget_rows)

    def _merge_runs_inner(self, budget_rows: int) -> None:
        from numpy.lib.format import open_memmap
        by_size = sorted(self._runs, key=lambda r: r[2])
        victims = by_size[:self.max_runs]
        survivors = by_size[self.max_runs:]
        for kp, pp, _ in victims:
            self._wait_pending(kp)
            self._wait_pending(pp)
        srcs = [(np.load(kp, mmap_mode="r"), np.load(pp, mmap_mode="r"))
                for kp, pp, _ in victims]
        total = sum(ln for _, _, ln in victims)
        out_kp = os.path.join(self.spill_dir,
                              f"run_{self._run_seq:06d}.keys.npy")
        out_pp = os.path.join(self.spill_dir,
                              f"run_{self._run_seq:06d}.pids.npy")
        self._run_seq += 1
        mk = open_memmap(out_kp, mode="w+", dtype=_U64, shape=(total,))
        mp = open_memmap(out_pp, mode="w+", dtype=np.int64, shape=(total,))
        pos = 0
        crc_k = crc_p = 0
        for ck, cp in merge_sorted_sources(srcs, num_key_cols=1,
                                           budget_rows=budget_rows):
            mk[pos:pos + ck.shape[0]] = ck
            mp[pos:pos + cp.shape[0]] = cp
            crc_k = crc32_update(crc_k, ck)
            crc_p = crc32_update(crc_p, cp)
            pos += ck.shape[0]
        mk.flush()
        mp.flush()
        del mk, mp, srcs
        self._sums[out_kp], self._sums[out_pp] = crc_k, crc_p
        self._verified.update((out_kp, out_pp))
        if self.io is not None:
            self.io.bump("merge_passes")
            self.io.count_sort(total, total * 16)
        for kp, pp, _ in victims:
            for p in (kp, pp):
                self._mmaps.pop(p, None)
                self._sums.pop(p, None)
                self._verified.discard(p)
                os.remove(p)
        self._runs = survivors + [(out_kp, out_pp, total)]

    # --------------------------------------------------------------- misc
    def slice_copy(self) -> "SigStore":
        """Materialize (memory + all disk runs) as a plain in-RAM copy."""
        keys, pids = self.merged_arrays()
        return SigStore(keys, pids, presorted=True)

    def merged_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Fully materialized sorted (keys, pids) — tests/debugging only."""
        for path in list(self._pending):
            self._wait_pending(path)
        ks = [self.keys] + [np.load(kp) for kp, _, _ in self._runs]
        ps = [self.pids] + [np.load(pp) for _, pp, _ in self._runs]
        keys = np.concatenate(ks)
        pids = np.concatenate(ps)
        order = np.argsort(keys, kind="stable")
        return keys[order], pids[order]

    def to_dict(self) -> dict:
        keys, pids = self.merged_arrays()
        return {int(k): int(p) for k, p in zip(keys.tolist(), pids.tolist())}

    # --------------------------------------------------------- durability
    def flush(self) -> None:
        """Force the whole store onto disk: spill the resident run (if
        any) and wait out in-flight async writes, so `state()` describes
        files that actually exist with final bytes.  Used by snapshots."""
        self._spill()
        for path in list(self._pending):
            self._wait_pending(path)

    def state(self) -> dict:
        """Portable description of the on-disk runs (paths relative to
        ``spill_dir``) with their lengths and checksums — everything a
        restore needs to re-adopt the runs from a snapshot copy.  Call
        `flush()` first; a non-empty resident run is an error here."""
        if self.keys.shape[0]:
            raise RuntimeError("state() requires flush() first: resident "
                               "run not spilled")
        rel = os.path.relpath
        return {
            "run_seq": self._run_seq,
            "runs": [[rel(kp, self.spill_dir), rel(pp, self.spill_dir), ln]
                     for kp, pp, ln in self._runs],
            "sums": {rel(p, self.spill_dir): c
                     for p, c in self._sums.items()},
        }

    def adopt_state(self, state: dict) -> None:
        """Bind this (empty) store to run files already present in
        ``spill_dir`` as described by a prior `state()`.  Checksums are
        re-verified lazily on each run's first mmap, so a corrupted
        snapshot run raises `ChecksumError` at first probe."""
        if len(self):
            raise RuntimeError("adopt_state() requires an empty store")
        join = os.path.join
        self._run_seq = int(state["run_seq"])
        self._runs = [(join(self.spill_dir, kp), join(self.spill_dir, pp),
                       int(ln)) for kp, pp, ln in state["runs"]]
        self._sums = {join(self.spill_dir, p): int(c)
                      for p, c in state["sums"].items()}
        self._verified = set()

    def close(self) -> None:
        """Delete the spill runs (and the spill dir if we created it)."""
        for path in list(self._pending):
            fut = self._pending.pop(path, None)
            if fut is not None:
                try:
                    fut.result()
                except BaseException:
                    pass  # tearing down anyway; the file is removed below
        self._mmaps.clear()
        for kp, pp, _ in self._runs:
            for p in (kp, pp):
                if os.path.exists(p):
                    os.remove(p)
        self._runs = []
        self._sums = {}
        self._verified = set()
        if self._owns_dir:
            import shutil
            shutil.rmtree(self.spill_dir, ignore_errors=True)
