"""Array-backed signature store S (paper §3.2, sorted-file implementation).

The port's own copy of the base `SigStore` of `repro.core.sig_store`: one
sorted ``uint64`` key column (the fused ``hi << 32 | lo`` signature hash)
plus a parallel ``int64`` pid column, with the paper's bulk operations
(lookup = ``np.searchsorted``, insert = sort + merge, get_or_assign =
Algorithm 4 lines 13-17 over a whole frontier).  Level 0 keys the store by
``uint64(node_label)`` (hi lane 0).

It is host-side numpy: the build extracts each level's store from the
(hi, lo) lanes it already computed.  ``SpillableSigStore`` arrives with
the out-of-core slice.
"""
from __future__ import annotations

import numpy as np


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
        _, found = self.lookup(np.asarray([key], dtype=_U64))
        return bool(found[0])

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Bulk lookup. Returns (pids int64, found bool); missing -> -1."""
        keys = np.asarray(keys, dtype=_U64)
        n_mem = int(self.keys.shape[0])
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
