"""Public wrappers around the fold kernel + the host-side layout builder.

The port of `repro.kernels.ops`: `edge_hash` is plain PyTorch, as it is
plain jnp in the JAX package; `blocked_csr_layout` is the port's own copy
of the numpy builder of the blocked-CSR layout `sig_fold` consumes; and
`sig_fold_from_layout` gathers pId_{j-1}(tgt) and runs the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import signatures as sig
from .sig_fold import frontier_sig_fold, sig_fold, sig_fold_plain

__all__ = ["edge_hash", "blocked_csr_layout", "sig_fold_from_layout",
           "sig_fold", "sig_fold_plain", "frontier_sig_fold"]


def edge_hash(elabel: torch.Tensor, pid_tgt: torch.Tensor):
    """Per-edge signature hash (oracle = ref.edge_hash_ref): u32 lanes in
    int64."""
    return sig.hash_pair(elabel, pid_tgt)


def blocked_csr_layout(src: np.ndarray, dst: np.ndarray, elabel: np.ndarray,
                       num_nodes: int, *, nodes_per_block: int = 8,
                       edges_per_block_align: int = 128):
    """Build the blocked-CSR layout sig_fold consumes.

    Edges (sorted by src) are grouped by source node-block; every block is
    padded to a common edge budget so the kernel's grid is rectangular.
    Returns dict of padded arrays + meta. Skew cost: total padding is
    (num_blocks * eb - E); heavy-hub graphs should use larger blocks.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    elabel = np.asarray(elabel)
    nb = nodes_per_block
    num_blocks = -(-num_nodes // nb)
    blk_of_edge = (src // nb).astype(np.int64)
    counts = np.bincount(blk_of_edge, minlength=num_blocks)
    eb = max(int(counts.max(initial=0)), 1)
    eb = -(-eb // edges_per_block_align) * edges_per_block_align
    e_lab = np.zeros(num_blocks * eb, dtype=np.int32)
    e_dst = np.zeros(num_blocks * eb, dtype=np.int32)
    e_lsrc = np.zeros(num_blocks * eb, dtype=np.int32)
    e_valid = np.zeros(num_blocks * eb, dtype=bool)
    if src.size:
        # Fully vectorized scatter: stable-sort edges by block, compute each
        # edge's slot within its block from the block start offsets, and
        # write all columns with one fancy-indexed assignment each.
        order = np.argsort(blk_of_edge, kind="stable")
        blk_sorted = blk_of_edge[order]
        starts = np.zeros(num_blocks + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(src.size, dtype=np.int64) - starts[blk_sorted]
        flat = blk_sorted * eb + slot
        e_lab[flat] = elabel[order]
        e_dst[flat] = dst[order]
        e_lsrc[flat] = (src[order] - blk_sorted * nb).astype(np.int32)
        e_valid[flat] = True
    return dict(
        elabel=e_lab, dst=e_dst, local_src=e_lsrc, valid=e_valid,
        nodes_per_block=nb, edges_per_block=eb, num_blocks=num_blocks,
        padded_nodes=num_blocks * nb)


def sig_fold_from_layout(elabel, dst, local_src, valid, pid_prev, *,
                         nodes_per_block: int, edges_per_block: int,
                         num_nodes: int):
    """Gather pid_prev[dst] then run the sig_fold kernel; trims padding."""
    pid_tgt = pid_prev[dst.to(torch.int64)]
    hi, lo = sig_fold(
        elabel, pid_tgt, local_src, valid, nodes_per_block=nodes_per_block,
        edges_per_block=edges_per_block)
    return hi[:num_nodes], lo[:num_nodes]
