"""The signature fold (Algorithm 1 lines 14-15) as a hand-written Hopper
kernel, with its plain PyTorch version.

Port of `repro.kernels.sig_fold._kernel` (reached through `sig_fold` and
`frontier_sig_fold`).  For each lane i of block ``i // edges_per_block``:
hash (eLabel, pId) into two u32 lanes, mask by ``valid`` and, with
``dedup``, drop a lane whose (local_src, eLabel, pId) triple equals the
previous lane's in its block (bitonic-sorting the block first unless
``presorted``); then wrap-add (mod 2^32) the surviving lanes into row
``block * nodes_per_block + local_src``.  Lanes whose local_src lies
outside ``[0, nodes_per_block)`` fall out, as the reference's broadcast
compare drops them.

On a CUDA tensor `sig_fold` launches the kernel in ``csrc/sig_fold.cu``
(built at first use by `_build`) or raises; only a tensor on the CPU takes
`sig_fold_plain`.  Outputs are u32 lanes carried in int64.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.signatures import MASK32, hash_pair

# dynamic shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232_448
_LANE_BYTES = 12  # (local_src, eLabel, pId) per lane in the bitonic route
MAX_SORTED_EDGES_PER_BLOCK = 1 << ((_SMEM_LIMIT // _LANE_BYTES).bit_length() - 1)


def _check(elabel, pid_tgt, local_src, valid, nb: int, eb: int,
           dedup: bool, presorted: bool) -> int:
    cols = (elabel, pid_tgt, local_src, valid)
    n = elabel.numel()
    for name, t, dt in zip(("elabel", "pid_tgt", "local_src", "valid"), cols,
                           (torch.int32,) * 3 + (torch.bool,)):
        if t.dtype != dt or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"sig_fold: {name} must be a 1-D {dt} tensor "
                             f"of {n} lanes, got {t.dtype} {tuple(t.shape)}")
        if t.device != elabel.device:
            raise ValueError("sig_fold: all lanes must lie on one device")
    if not 0 < nb < 2 ** 31:
        raise ValueError(f"sig_fold: nodes_per_block={nb} must lie in "
                         "[1, 2^31)")
    if eb < 1 or n % eb:
        raise ValueError(f"sig_fold: {n} lanes are not a whole number of "
                         f"blocks of edges_per_block={eb}")
    if dedup and not presorted and eb & (eb - 1):
        raise ValueError("sig_fold: the in-kernel sort needs a power-of-two "
                         f"edges_per_block, got {eb}")
    return n


def sig_fold_plain(elabel, pid_tgt, local_src, valid, *,
                   nodes_per_block: int, edges_per_block: int,
                   dedup: bool = False, presorted: bool = False):
    """The fold in plain PyTorch ops: same arguments, same bits as the
    kernel.  Used by the CPU route and as the card's comparison."""
    nb, eb = nodes_per_block, edges_per_block
    n = _check(elabel, pid_tgt, local_src, valid, nb, eb, dedup, presorted)
    dev = elabel.device
    blk = torch.arange(n, device=dev) // eb
    s = torch.where(valid, local_src.to(torch.int64), nb)
    a, b = elabel.to(torch.int64), pid_tgt.to(torch.int64)
    keep = valid
    if dedup and presorted:
        first = torch.arange(n, device=dev) % eb == 0
        same = torch.zeros_like(first)
        same[1:] = (s[1:] == s[:-1]) & (a[1:] == a[:-1]) & (b[1:] == b[:-1])
        keep = valid & (first | ~same)
    keep = keep & (s >= 0) & (s < nb)
    rows = blk * nb + s
    if dedup and not presorted:
        # in-block sort + adjacent compare keeps one lane per distinct
        # (block, local_src, eLabel, pId)
        uniq = torch.unique(torch.stack([rows, a, b], 1)[keep], dim=0)
        rows, a, b = uniq[:, 0], uniq[:, 1], uniq[:, 2]
        keep = torch.ones_like(rows, dtype=torch.bool)
    hi, lo = hash_pair(a, b)
    rows = torch.where(keep, rows, 0)
    zero = torch.zeros((n // eb) * nb, dtype=torch.int64, device=dev)
    out_hi = zero.index_add(0, rows, torch.where(keep, hi, 0))
    out_lo = zero.index_add(0, rows, torch.where(keep, lo, 0))
    return out_hi & MASK32, out_lo & MASK32


def _launch(elabel, pid_tgt, local_src, valid, nb: int, eb: int,
            dedup: bool, presorted: bool):
    from ._build import load
    sort = dedup and not presorted
    if sort and eb * _LANE_BYTES > _SMEM_LIMIT:
        raise ValueError(
            f"sig_fold: edges_per_block={eb} needs {eb * _LANE_BYTES} B of "
            f"shared memory for the in-kernel sort; the limit is "
            f"{_SMEM_LIMIT} B (edges_per_block <= "
            f"{MAX_SORTED_EDGES_PER_BLOCK})")
    cols = (elabel, pid_tgt, local_src, valid)
    if not all(t.is_contiguous() for t in cols):
        raise ValueError("sig_fold: lanes must be contiguous")
    n = elabel.numel()
    out = torch.zeros((2, (n // eb) * nb), dtype=torch.int32,
                      device=elabel.device)
    if n:
        lib = load("sig_fold")
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*cols, *out)]
        with torch.cuda.device(elabel.device):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            if sort:
                err = lib.sig_fold_bitonic(*ptrs, n // eb, eb, nb, stream)
            else:
                err = lib.sig_fold_flat(*ptrs, n, eb, nb, int(dedup), stream)
        if err:
            raise RuntimeError(f"sig_fold: kernel launch failed with CUDA "
                               f"error {err}")
        sig_fold.launches += 1
    hi, lo = out.to(torch.int64) & MASK32
    return hi, lo


def sig_fold(elabel, pid_tgt, local_src, valid, *, nodes_per_block: int,
             edges_per_block: int, dedup: bool = False,
             presorted: bool = False):
    """Blocked-CSR segmented signature fold.

    elabel/pid_tgt/local_src: int32 [num_blocks * edges_per_block];
    valid: bool (same shape); local_src is src minus the block's node base.
    Returns (seg_hi, seg_lo): u32 lanes in int64
    [num_blocks * nodes_per_block].

    ``dedup=True`` keeps one lane per (local_src, eLabel, pId) triple in
    each block: by adjacent compare when ``presorted`` promises the lanes
    arrive in triple order, after an in-kernel bitonic sort otherwise (a
    power-of-two ``edges_per_block`` that fits shared memory).
    """
    nb, eb = nodes_per_block, edges_per_block
    if elabel.device.type == "cpu":
        return sig_fold_plain(elabel, pid_tgt, local_src, valid,
                              nodes_per_block=nb, edges_per_block=eb,
                              dedup=dedup, presorted=presorted)
    _check(elabel, pid_tgt, local_src, valid, nb, eb, dedup, presorted)
    if elabel.device.type != "cuda":
        raise ValueError(f"sig_fold: no kernel for device {elabel.device}")
    return _launch(elabel, pid_tgt, local_src, valid, nb, eb, dedup,
                   presorted)


sig_fold.launches = 0  # kernel launches made through the wrapper


def frontier_sig_fold(elabel, pid_tgt, seg, valid, *, num_sigs: int,
                      dedup: bool = False, presorted: bool = True):
    """One single-block `sig_fold` over a whole edge batch.

    ``seg`` plays local_src (entries >= num_sigs match no row) and the
    batch length is the edge budget; the kernel tiles the one block over
    the whole card.  The in-memory build folds every iteration through
    this form; an empty batch launches nothing.
    Returns (seg_hi, seg_lo): u32 lanes in int64 [num_sigs].
    """
    n = elabel.numel()
    if n == 0:
        zero = torch.zeros(num_sigs, dtype=torch.int64, device=elabel.device)
        return zero, zero.clone()
    return sig_fold(elabel, pid_tgt, seg.to(torch.int32), valid,
                    nodes_per_block=num_sigs, edges_per_block=n,
                    dedup=dedup, presorted=presorted)
