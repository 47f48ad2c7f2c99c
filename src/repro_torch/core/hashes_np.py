"""Bit-exact numpy replicas of the hash primitives in signatures.py.

The out-of-core build ranks each node window on the host, and the
maintenance algorithms (paper §4) recompute signatures for *sparse
frontiers* of nodes there; those signatures must hash identically to the
ones the bulk engine stores in S during construction.

The port's own copy of `repro.core.hashes_np` (numpy only).
"""
from __future__ import annotations

import numpy as np

_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)
_C3 = np.uint32(0xC2B2AE3D)
_C4 = np.uint32(0x27D4EB2F)
_C5 = np.uint32(0x165667B1)
_SEED_LO = np.uint32(0x2545F491)
_SEED_HI = np.uint32(0x9E3779B9)


def fmix32(h):
    with np.errstate(over="ignore"):
        h = np.asarray(h, dtype=np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def hash_pair(a, b):
    with np.errstate(over="ignore"):
        a = np.asarray(a).astype(np.uint32)
        b = np.asarray(b).astype(np.uint32)
        lo = fmix32(a * _C1 + b * _C2 + _SEED_LO)
        hi = fmix32(a * _C3 + b * _C4 + _SEED_HI)
        return fmix32(hi + lo * _C5), lo


def hash_triple(a, b, c):
    with np.errstate(over="ignore"):
        c = np.asarray(c).astype(np.uint32)
        h1, l1 = hash_pair(a, b)
        return hash_pair(h1 + c * _C5, l1 ^ c)


def node_signature(pid0_u: int, elabels: np.ndarray, pid_tgts: np.ndarray,
                   *, dedup: bool = True):
    """sig_j hash pair for one node given its out-edge (eLabel, pid) pairs."""
    e_hi, e_lo = hash_pair(elabels, pid_tgts)
    if dedup and e_hi.size:
        key = (np.asarray(elabels).astype(np.int64) << np.int64(32)) | \
            np.asarray(pid_tgts).astype(np.int64)
        _, first = np.unique(key, return_index=True)
        e_hi, e_lo = e_hi[first], e_lo[first]
    seg_hi = np.uint32(e_hi.sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    seg_lo = np.uint32(e_lo.sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    hi, lo = hash_triple(seg_hi, seg_lo, np.uint32(pid0_u))
    return int(hi), int(lo)


def signatures_from_edges(pid0_vals: np.ndarray, seg: np.ndarray,
                          elabel: np.ndarray, pid_tgt: np.ndarray,
                          num_sigs: int, *, dedup: bool = True):
    """sig hash pairs for `num_sigs` nodes from their gathered out-edges.

    seg[i] tells which of the num_sigs nodes edge i belongs to;
    pid0_vals is that node's pId_0 (length num_sigs). One lexsort dedup +
    segment wrap-sum over the gathered edges — no Python loop, and cost
    proportional to the gathered edges only (not |E|).
    """
    seg_hi = np.zeros(num_sigs, dtype=np.uint32)
    seg_lo = np.zeros(num_sigs, dtype=np.uint32)
    total = int(np.asarray(elabel).shape[0])
    if total:
        lab = np.asarray(elabel)
        tgt = np.asarray(pid_tgt)
        seg = np.asarray(seg)
        if dedup:
            order = np.lexsort((tgt, lab, seg))
            sseg, slab, stgt = seg[order], lab[order], tgt[order]
            keep = np.ones(total, dtype=bool)
            keep[1:] = ((sseg[1:] != sseg[:-1]) | (slab[1:] != slab[:-1])
                        | (stgt[1:] != stgt[:-1]))
            seg, lab, tgt = sseg[keep], slab[keep], stgt[keep]
        e_hi, e_lo = hash_pair(lab, tgt)
        with np.errstate(over="ignore"):
            # per-segment sum mod 2^32 in each lane (order-independent)
            np.add.at(seg_hi, seg, e_hi)
            np.add.at(seg_lo, seg, e_lo)
    return hash_triple(seg_hi, seg_lo, pid0_vals)


def csr_gather(offsets: np.ndarray, nodes: np.ndarray):
    """Edge indices of all CSR rows in `nodes`, concatenated.

    Returns (idx int64 [sum deg], seg int64 [sum deg]) where seg[i] is the
    position in `nodes` that idx[i]'s edge belongs to. Shared by the batch
    signature path below and the maintenance frontier gathers.
    """
    offsets = np.asarray(offsets)
    nodes = np.asarray(nodes, dtype=np.int64)
    starts = offsets[nodes].astype(np.int64)
    cnts = offsets[nodes + 1].astype(np.int64) - starts
    total = int(cnts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    seg = np.repeat(np.arange(nodes.shape[0], dtype=np.int64), cnts)
    ends = np.cumsum(cnts)
    idx = np.arange(total, dtype=np.int64) + np.repeat(
        starts - (ends - cnts), cnts)
    return idx, seg


def node_signatures_batch(pid0: np.ndarray, offsets: np.ndarray,
                          elabel: np.ndarray, pid_tgt: np.ndarray,
                          nodes: np.ndarray, *, dedup: bool = True):
    """Signatures for a batch of nodes (CSR out-edge layout), vectorized.

    offsets: CSR row offsets [N+1] over edge arrays sorted by src.
    elabel/pid_tgt: per-edge columns in CSR order.
    nodes: node ids to compute signatures for.
    Returns (hi, lo) uint32 [len(nodes)], bit-identical to mapping
    `node_signature` over the batch (asserted by tests) — the whole batch
    is one CSR gather + lexsort dedup + segment wrap-sum, no Python loop.
    """
    nodes = np.asarray(nodes, dtype=np.int64)
    idx, seg = csr_gather(offsets, nodes)
    return signatures_from_edges(
        np.asarray(pid0)[nodes], seg, np.asarray(elabel)[idx],
        np.asarray(pid_tgt)[idx], nodes.shape[0], dedup=dedup)
