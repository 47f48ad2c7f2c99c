"""Plain-PyTorch oracles for the port's kernel functions (the port of
`repro.kernels.ref`, without the attention oracle, which arrives with the
attention kernel)."""
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
