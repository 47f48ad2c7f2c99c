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
  reference's ``chunk``).

Either way the residuals are (q, k, v, o, lse): O(S), not O(S^2).  Causal
masks, right-aligned queries (``q_offset``), sliding windows, the logit
softcap and GQA grouping as in the reference (q: [B, Sq, H, D], k/v:
[B, Skv, Hkv, D]).  The kernels read these as [B, H, S, D] views through
their strides, so nothing is transposed in memory.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain,
                                       flash_attention_fwd_plain,
                                       tma_loadable)


def _heads_first(*ts):
    return [t.transpose(1, 2) for t in ts]


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the layers' [B, S, H, D] convention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, chunk):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        qh, kh, vh = _heads_first(q, k, v)
        if q.device.type == "cpu":
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
                                  and not tma_loadable(do.transpose(1, 2))):
            do = do.clone(memory_format=torch.contiguous_format)
        args = _heads_first(q, k, v) + [o, lse, do.transpose(1, 2)]
        if q.device.type == "cpu":
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
    return FlashAttention.apply(q, k, v, causal, window, softcap, q_offset,
                                chunk)
