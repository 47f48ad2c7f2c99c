"""Plain-PyTorch oracles for the port's kernel functions (the port of
`repro.kernels.ref`), and `chunk_fold_ref`, the twin of the JAX package's
host keep mask plus `repro.exmem.build._fold_chunk`."""
from __future__ import annotations

import math

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


def attention_mask(sq: int, skv: int, *, causal: bool, window, device,
                   q_offset=None):
    """[sq, skv] bool, True where query row i may see key j: qpos = i +
    q_offset (default skv - sq: right-aligned queries), causal qpos >=
    kpos, window qpos - kpos < window."""
    off = skv - sq if q_offset is None else q_offset
    qpos = torch.arange(sq, device=device)[:, None] + off
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  softcap=None, scale=None):
    """Oracle for kernels.flash_attention: materialized logits, masked
    with -inf, softmax in f32.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device)
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.float())
    return out.to(q.dtype)
