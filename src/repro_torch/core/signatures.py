"""Signature construction for k-bisimulation (Definition 3 of the paper).

The port of `repro.core.signatures`: every signature is a pair of
independent 32-bit mix-hashes, and `S.insert` is the dense ranking of those
pairs (the paper's sort-based bulk implementation of S, §3.2).  All outputs
are integers and equal the JAX package's bit for bit.

u32 lanes are carried in ``int64`` tensors holding values in
``[0, 2**32)``: CPU PyTorch has no u32 ``+``, ``>>`` or ``index_add_``,
and the CPU and CUDA routes must compare like with like.  Products are
split so that no intermediate leaves the int64 range.

Per iteration the fold runs through the hand-written Hopper kernel
(`repro_torch.kernels.sig_fold`) in all three modes; what surrounds it
(the pid gather, the sorts, the dense ranks) is plain PyTorch, as it is
plain jnp outside the Pallas kernel in the JAX package:

  * ``sorted``     — sort the (src, eLabel, pid) triples, fold with the
                     kernel's adjacent-compare dedup (presorted lanes);
  * ``dedup_hash`` — sort the per-edge 64-bit hash within source segments,
                     mask duplicates, fold the surviving lanes;
  * ``multiset``   — no sort: fold every edge (counting bisimulation).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# xxhash/murmur-style odd constants (those of the JAX package).
_C1 = 0x9E3779B1
_C2 = 0x85EBCA77
_C3 = 0xC2B2AE3D
_C4 = 0x27D4EB2F
_C5 = 0x165667B1
_SEED_LO = 0x2545F491
_SEED_HI = 0x9E3779B9

MODES = ("sorted", "dedup_hash", "multiset")


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's u32 reinterpretation, carried in int64."""
    return x.to(torch.int64) & MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for u32 lanes h and a u32 constant c, computed in
    16-bit halves of c so that no product overflows int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (bijective avalanche mix)."""
    h = as_u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_pair(a: torch.Tensor, b: torch.Tensor):
    """64-bit (as two u32 lanes) hash of an integer pair."""
    a = as_u32(a)
    b = as_u32(b)
    lo = fmix32((_mul32(a, _C1) + _mul32(b, _C2) + _SEED_LO) & MASK32)
    hi = fmix32((_mul32(a, _C3) + _mul32(b, _C4) + _SEED_HI) & MASK32)
    # cross-mix the lanes so (hi, lo) are not independent of lane swaps
    return fmix32((hi + _mul32(lo, _C5)) & MASK32), lo


def hash_triple(a, b, c):
    c = as_u32(c)
    h1, l1 = hash_pair(a, b)
    return hash_pair((h1 + _mul32(c, _C5)) & MASK32, l1 ^ c)


def fuse_u32_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key whose signed order is the unsigned (hi, lo) order.

    Shifting hi down by 2^31 first (its sign bit flipped) keeps the key in
    range; a plain ``hi << 32 | lo`` would order every hi >= 2^31 first.
    """
    return (as_u32(hi) - (1 << 31)) * (1 << 32) + as_u32(lo)


def _dense_rank_sorted(x: torch.Tensor):
    sx, order = torch.sort(x)
    new = torch.ones_like(sx, dtype=torch.bool)
    new[1:] = sx[1:] != sx[:-1]
    ranks = (torch.cumsum(new, 0) - 1).to(torch.int32)
    pid = torch.empty_like(ranks)
    pid[order] = ranks
    return pid, new.sum().to(torch.int32)


def dense_rank_pairs(hi: torch.Tensor, lo: torch.Tensor):
    """Dense-rank (hi, lo) hash pairs in unsigned lexicographic order: equal
    pair -> equal rank in [0, P).

    Returns (rank int32 [n], num_partitions int32 0-dim), both on the
    input's device (no host sync).
    """
    return _dense_rank_sorted(fuse_u32_pair(hi, lo))


def dense_rank_ints(x: torch.Tensor):
    """Dense-rank plain integers in signed order (pId_0 from node labels)."""
    return _dense_rank_sorted(x)


def segment_wrapsum(vals: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-segment wrap-add (mod 2^32) of contiguous segments.

    ``bounds`` [S+1] delimit the segments of the u32 lanes ``vals``.  The
    int64 running sum is exact (lanes < 2^32, fewer than 2^31 of them), so
    the masked difference of two boundary gathers is the segment's
    wrap-add total.
    """
    starts = bounds[:-1].to(torch.int64)
    ends = bounds[1:].to(torch.int64)
    if vals.numel() == 0:
        return torch.zeros(starts.shape, dtype=torch.int64,
                           device=vals.device)
    cs = torch.cumsum(as_u32(vals), 0)
    upper = cs[torch.clamp(ends - 1, min=0)]
    lower = torch.where(starts > 0, cs[torch.clamp(starts - 1, min=0)],
                        torch.zeros_like(upper))
    return torch.where(ends > starts, (upper - lower) & MASK32,
                       torch.zeros_like(upper))


def _sort_triples(s, a, b, *, num_nodes: int, elabel_range,
                  pid_bound=None):
    """(s, a, b) int32 columns in an order where equal triples are adjacent.

    Any total order gives the fold the same bits (only adjacency of equal
    triples matters, and the sum is order-free).  When the three fields
    fit 63 bits — source below ``num_nodes``, pid below ``pid_bound``
    (default ``num_nodes``: a build's pids are dense ranks; maintained
    pids may reach past it), labels inside ``elabel_range`` — one sort of
    a fused int64 key does it and the columns are decoded from the sorted
    keys; otherwise two stable sorts, least-significant key first.
    """
    lo_lab, hi_lab = elabel_range
    nbits = max(num_nodes - 1, 0).bit_length()
    pbits = max((num_nodes if pid_bound is None else pid_bound) - 1,
                0).bit_length()
    lbits = max(hi_lab - lo_lab, 0).bit_length()
    if nbits + pbits + lbits <= 63:
        key = ((s.to(torch.int64) << (lbits + pbits))
               | ((a.to(torch.int64) - lo_lab) << pbits)
               | b.to(torch.int64))
        key = torch.sort(key).values
        return ((key >> (lbits + pbits)).to(torch.int32),
                (((key >> pbits) & ((1 << lbits) - 1)) + lo_lab)
                .to(torch.int32),
                (key & ((1 << pbits) - 1)).to(torch.int32))
    order = torch.sort(b, stable=True).indices
    major = (s[order].to(torch.int64) << 32) | as_u32(a[order])
    order = order[torch.sort(major, stable=True).indices]
    return s[order], a[order], b[order]


def fold_lanes(src, dst, elabel, pid_prev, *, num_nodes: int, mode: str,
               elabel_range=None, pid_bound=None):
    """The lanes one iteration hands to the fold kernel, per mode.

    Returns (elabel, pid_tgt, seg, valid, dedup): int32 columns in fold
    order, the bool lane mask, and whether the kernel drops adjacent equal
    (seg, eLabel, pid) triples.  ``elabel_range`` (min, max) bounds the
    edge labels for the fused sort key of ``sorted`` mode; None reads it
    from ``elabel`` (a host sync); ``pid_bound`` bounds ``pid_prev``
    (default ``num_nodes``).
    """
    pid_tgt = pid_prev[dst]  # the sort-merge join E_t ⋈ N_t (line 10, Alg. 1)
    if mode == "sorted":
        # Paper-faithful: sort F = (sId, eLabel, pId_old_tId); the kernel
        # drops the duplicates (lines 12-13 of Algorithm 1) in-lane.
        if elabel_range is None:
            elabel_range = ((int(elabel.min()), int(elabel.max()))
                            if elabel.numel() else (0, 0))
        s, a, b = _sort_triples(src, elabel, pid_tgt, num_nodes=num_nodes,
                                elabel_range=elabel_range,
                                pid_bound=pid_bound)
        return a, b, s, torch.ones_like(s, dtype=torch.bool), True
    if mode == "dedup_hash":
        # Sort the fused 64-bit edge hash within source segments and mask
        # duplicates; the kernel re-hashes the surviving lanes to the same
        # bits.
        e_hi, e_lo = hash_pair(elabel, pid_tgt)
        key = fuse_u32_pair(e_hi, e_lo)
        order = torch.sort(key, stable=True).indices
        order = order[torch.sort(src[order], stable=True).indices]
        s_src, s_key = src[order], key[order]
        dup = torch.zeros_like(s_src, dtype=torch.bool)
        dup[1:] = (s_src[1:] == s_src[:-1]) & (s_key[1:] == s_key[:-1])
        return elabel[order], pid_tgt[order], s_src, ~dup, False
    if mode == "multiset":
        # Sort-free: order-independent multiset hash (counting bisimulation).
        return (elabel, pid_tgt, src, torch.ones_like(src, dtype=torch.bool),
                False)
    raise ValueError(f"unknown signature mode: {mode}")


def signature_hashes(pid0, src, dst, elabel, pid_prev, *, num_nodes: int,
                     mode: str = "sorted", elabel_range=None,
                     pid_bound=None):
    """Compute sig_j hash pairs for every node.

    pid0      int32 [N]  iteration-0 partition ids
    src/dst/elabel int32 [E]  edge columns (any order)
    pid_prev  int32 [N]  iteration j-1 partition ids

    Returns (sig_hi, sig_lo): u32 lanes in int64 [N].  Empty segments get
    the identity (0, 0) before the final mix, as in the JAX package.
    """
    from ..kernels.sig_fold import frontier_sig_fold
    a, b, seg, valid, dedup = fold_lanes(
        src, dst, elabel, pid_prev, num_nodes=num_nodes, mode=mode,
        elabel_range=elabel_range, pid_bound=pid_bound)
    seg_hi, seg_lo = frontier_sig_fold(a, b, seg, valid, num_sigs=num_nodes,
                                       dedup=dedup, presorted=True)
    return hash_triple(seg_hi, seg_lo, pid0)


def frontier_signature_hashes_presorted(pid0, elabel, pid_tgt, bounds,
                                        count: int, *, num_sigs: int):
    """Segless frontier fold: hash + segment wrap-sum + final mix, for
    edge batches already grouped by frontier position (``bounds``
    [num_sigs + 1]) and, under set semantics, already deduplicated.

    ``seg`` is recovered from ``bounds`` on the tensors' device (lane i
    lies in the segment whose bounds bracket it; lanes at or past
    ``count`` get seg = num_sigs and match no row), and the fold runs
    through `frontier_sig_fold`: the Hopper kernel on a CUDA tensor.
    Returns (hi, lo): u32 lanes in int64 [num_sigs].
    """
    from ..kernels.sig_fold import frontier_sig_fold
    n = elabel.numel()
    lane = torch.arange(n, device=elabel.device)
    seg = torch.searchsorted(bounds[1:num_sigs + 1].to(torch.int64), lane,
                             right=True)
    seg = torch.where(lane < count, seg, num_sigs)
    seg_hi, seg_lo = frontier_sig_fold(
        elabel, pid_tgt, seg.to(torch.int32), lane < count,
        num_sigs=num_sigs)
    return hash_triple(seg_hi, seg_lo, pid0)


def frontier_signature_hashes(pid0, seg, elabel, pid_tgt, count: int, *,
                              num_sigs: int, dedup: bool = True):
    """The frontier fold of maintenance (§4), the twin of
    `hashes_np.signatures_from_edges` over device tensors.

    seg[i] is the frontier position of edge i (lanes at or past
    ``count`` carry seg >= num_sigs); elabel/pid_tgt are int32 carriers
    of u32 lanes; pid0 is each position's pId_0.  ``dedup`` keeps one
    lane per (seg, eLabel, pId) triple: the lanes are sorted here, on
    their device, and the kernel drops adjacent duplicates
    (``presorted``).  Multiset mode folds every valid lane.  The kernel
    folds by ``seg``, so the reference's ``bounds`` argument is dropped.
    Returns (hi, lo): u32 lanes in int64 [num_sigs].
    """
    from ..kernels.sig_fold import frontier_sig_fold
    valid = torch.arange(elabel.numel(), device=elabel.device) < count
    seg = torch.where(valid, seg.to(torch.int64), num_sigs)
    if dedup:
        # any order that makes equal triples adjacent gives the same
        # survivors: (eLabel, pId) as one int64 key, then seg, stable
        pair = (as_u32(elabel) << 32) | as_u32(pid_tgt)
        order = torch.sort(pair, stable=True).indices
        order = order[torch.sort(seg[order], stable=True).indices]
        elabel, pid_tgt, seg, valid = (elabel[order], pid_tgt[order],
                                       seg[order], valid[order])
    seg_hi, seg_lo = frontier_sig_fold(
        elabel, pid_tgt, seg.to(torch.int32), valid, num_sigs=num_sigs,
        dedup=dedup, presorted=True)
    return hash_triple(seg_hi, seg_lo, pid0)
