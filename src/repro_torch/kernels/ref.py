"""Plain-PyTorch oracles for the port's kernel functions (the port of
`repro.kernels.ref`, without the attention oracle, which arrives with the
attention kernel), and `chunk_fold_ref`, the twin of the JAX package's
host keep mask plus `repro.exmem.build._fold_chunk`."""
from __future__ import annotations

import torch

from ..core import signatures as sig


def edge_hash_ref(elabel: torch.Tensor, pid_tgt: torch.Tensor):
    """Oracle for ops.edge_hash: per-edge 2x32-bit mix hash."""
    return sig.hash_pair(elabel, pid_tgt)


def sig_fold_ref(elabel, pid_tgt, src, valid, num_nodes: int):
    """Oracle for kernels.sig_fold: masked per-edge hash + segment-sum.

    elabel/pid_tgt/src: int32 [E]; valid: bool [E].
    Returns (seg_hi, seg_lo): u32 lanes in int64 [num_nodes].
    """
    e_hi, e_lo = sig.hash_pair(elabel, pid_tgt)
    seg = torch.where(valid, src.to(torch.int64), 0)
    zero = torch.zeros(num_nodes, dtype=torch.int64, device=elabel.device)
    seg_hi = zero.index_add(0, seg, torch.where(valid, e_hi, 0))
    seg_lo = zero.index_add(0, seg, torch.where(valid, e_lo, 0))
    return seg_hi & sig.MASK32, seg_lo & sig.MASK32


def chunk_fold_ref(elabel, pid_tgt, src, n: int, keep0: bool, *,
                   chunk_edges: int, dedup: bool):
    """Oracle for kernels.sig_fold.chunk_sig_fold, arranged as the JAX
    package's out-of-core build arranges its jnp fold: the host keep mask
    over the chunk's ``n`` real lanes (``src`` compared, not the segment
    ids), then a masked hash and a segment sum over ``chunk_edges`` rows.

    elabel/pid_tgt/src: int32 [n]; padding to ``chunk_edges`` is added
    here, with seg = chunk_edges - 1 and keep False, as the build pads.
    Returns (seg_hi, seg_lo): u32 lanes in int64 [chunk_edges].
    """
    dev = elabel.device
    new_src = torch.ones(n, dtype=torch.bool, device=dev)
    new_src[1:] = src[1:] != src[:-1]
    seg = torch.full((chunk_edges,), chunk_edges - 1, dtype=torch.int64,
                     device=dev)
    seg[:n] = torch.cumsum(new_src.to(torch.int64), 0) - 1
    keep = torch.zeros(chunk_edges, dtype=torch.bool, device=dev)
    keep[:n] = True
    if dedup and n:
        keep[1:n] = ((src[1:] != src[:-1]) | (elabel[1:] != elabel[:-1])
                     | (pid_tgt[1:] != pid_tgt[:-1]))
        keep[0] = bool(keep0)
    a = torch.zeros(chunk_edges, dtype=torch.int64, device=dev)
    b = torch.zeros(chunk_edges, dtype=torch.int64, device=dev)
    a[:n], b[:n] = elabel, pid_tgt
    e_hi, e_lo = sig.hash_pair(a, b)
    zero = torch.zeros(chunk_edges, dtype=torch.int64, device=dev)
    seg_hi = zero.index_add(0, seg, torch.where(keep, e_hi, 0))
    seg_lo = zero.index_add(0, seg, torch.where(keep, e_lo, 0))
    return seg_hi & sig.MASK32, seg_lo & sig.MASK32
