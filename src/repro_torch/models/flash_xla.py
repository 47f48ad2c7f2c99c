"""Flash attention with a gradient (the port of `repro.models.flash_xla`).

The JAX package's ``flash_attention_xla`` is XLA code under a custom VJP:
its forward keeps only (o, lse), its backward recomputes the logits chunk
by chunk.  Here that VJP is a `torch.autograd.Function`:

- on the card, the forward is the hand-written `flash_attention` kernel
  with its ``lse`` output, and the backward the hand-written
  `flash_attention_bwd` kernel;
- on the CPU, both are the plain versions beside those kernels, the
  reference's ``_fwd_impl`` and ``_bwd_rule`` step for step
  (`flash_attention_fwd_plain`, `flash_attention_bwd_plain`, with the
  reference's ``chunk``);
- on fake tensors (the dry-run's trace), the kernels' custom ops, whose
  fake implementations give the shapes and whose FLOP formulas the
  counts.

Either way the residuals are (q, k, v, o, lse): O(S), not O(S^2).  Causal
masks, right-aligned queries (``q_offset``), sliding windows, the logit
softcap and GQA grouping as in the reference (q: [B, Sq, H, D], k/v:
[B, Skv, Hkv, D]).  The kernels read these as [B, H, S, D] views through
their strides, so nothing is transposed in memory.

Under a device mesh (DTensor q, k, v) the kernels run on each rank's local
heads: `local_heads` unwraps the shards (what ``local_map`` does), hands
the kernel the kv heads its q heads read, and wraps the output back.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain,
                                       flash_attention_fwd_plain,
                                       tma_loadable)
from ..launch.mesh import is_dtensor, local_offset


def _heads_first(*ts):
    return [t.transpose(1, 2) for t in ts]


def _fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _plain_route(t) -> bool:
    """Whether ``t`` takes the plain versions: a real CPU tensor."""
    return t.device.type == "cpu" and not _fake(t)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the layers' [B, S, H, D] convention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, chunk):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        qh, kh, vh = _heads_first(q, k, v)
        if _plain_route(q):
            o, lse = flash_attention_fwd_plain(qh, kh, vh, chunk=chunk, **kw)
        else:
            o, lse = flash_attention(qh, kh, vh, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.chunk = kw, chunk
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd, not the caller, picks dO's layout: a head_dim that is
        # not contiguous, or a bf16 view that TMA cannot load (a narrow
        # slice from torch.cat's backward), is copied to a dense one
        if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                                  and not _fake(do)
                                  and not tma_loadable(do.transpose(1, 2))):
            do = do.clone(memory_format=torch.contiguous_format)
        args = _heads_first(q, k, v) + [o, lse, do.transpose(1, 2)]
        if _plain_route(q):
            grads = flash_attention_bwd_plain(*args, chunk=ctx.chunk,
                                              **ctx.kw)
        else:
            grads = flash_attention_bwd(*args, **ctx.kw)
        return (*(g.transpose(1, 2) for g in grads),
                None, None, None, None, None)


def attend_flash(q, k, v, *, causal, window, softcap, q_offset: int = 0,
                 chunk: int = 512):
    """layers.py-convention attention with a gradient. q: [B,Sq,H,D];
    k/v: [B,Skv,Hkv,D] -> [B,Sq,H,D]."""
    return local_heads(lambda q, k, v: FlashAttention.apply(
        q, k, v, causal, window, softcap, q_offset, chunk), q, k, v)


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on [B, S, H, D] tensors; on DTensors, ``fn`` runs on
    each rank's shards and its output is wrapped back with q's placements.

    A mesh dim that splits q's batch splits k and v's too (no collective);
    one that splits q's heads splits k and v's heads where it can, and
    otherwise leaves them whole (GQA: 8 kv heads do not divide a 16-way
    axis): the rank then hands ``fn`` only the kv heads its q heads read,
    and its dk/dv come back as a sum over that axis (``Partial``), to be
    reduced where the caller pins them.  Any other placement (a split
    sequence) is gathered first.
    """
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp, kp, kg = [], [], []
    for pq, pk in zip(q.placements, k.placements):
        if pq == Shard(0) or (pq == Shard(2) and pk == Shard(2)):
            qp.append(pq), kp.append(pq), kg.append(pq)
        elif pq == Shard(2):
            qp.append(pq), kp.append(Replicate()), kg.append(Partial())
        else:
            qp.append(Replicate()), kp.append(Replicate())
            kg.append(Replicate())
    q, k, v = (t if tuple(t.placements) == tuple(want)
               else t.redistribute(mesh, want)
               for t, want in ((q, qp), (k, kp), (v, kp)))
    ql = q.to_local(grad_placements=qp)
    kl, vl = (t.to_local(grad_placements=kg) for t in (k, v))
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    h0 = local_offset(2, hq, mesh, qp)
    k0 = local_offset(2, hkv, mesh, kp)
    lo, hi = h0 // g, (h0 + ql.shape[2] - 1) // g + 1
    group = ql.shape[2] // (hi - lo)
    if not (k0 <= lo and hi <= k0 + kl.shape[2]) or any(
            (h0 + j) // g - lo != j // group for j in range(ql.shape[2])):
        raise ValueError(f"local_heads: q heads [{h0}, {h0 + ql.shape[2]}) "
                         f"of {hq} do not map onto whole kv heads of {hkv}")
    if (lo, hi) != (k0, k0 + kl.shape[2]):
        kl, vl = (t[:, :, lo - k0:hi - k0] for t in (kl, vl))
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(fn(ql, kl, vl), mesh, qp)
