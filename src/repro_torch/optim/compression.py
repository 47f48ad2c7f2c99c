"""Int8 gradient compression with error feedback (the port of
`repro.optim.compression`).

`compressed_psum` is the quantized reduce-scatter + all-gather mean over
the ranks of a `torch.distributed` process group, where the reference
takes a mesh axis inside ``shard_map``: the reduce-scatter is an
all-to-all of int8 chunks, as the reference's ``all_to_all(tiled=False)``,
followed by the all-gathers of the scales and of the re-quantized partial
means.  ``ef_compress``/``dequantize_int8`` are the host-math primitives
of the error-feedback buffers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def ef_compress(grad, error):
    """Error-feedback compression: returns (q, scale, new_error)."""
    g = grad.to(torch.float32) + error
    q, scale = quantize_int8(g)
    new_error = g - dequantize_int8(q, scale)
    return q, scale, new_error


def _all_gather(t, group, d):
    """[d, *t.shape]: every rank's ``t``, in rank order."""
    out = [torch.empty_like(t) for _ in range(d)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def compressed_psum(x, group=None):
    """Quantized reduce-scatter + all-gather mean over ``group``'s ranks
    (the default group if None): every rank passes its ``x`` (any shape)
    and gets the mean of all of them.  Bytes on the wire: 2 * |x| int8
    (+ scales) instead of 2 * |x| f32."""
    d = dist.get_world_size(group)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % d
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(d, (n + pad) // d)
    q, scale = quantize_int8(chunks)
    # reduce-scatter: every peer receives my chunk for its index
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    scales = _all_gather(scale, group, d)                # [d]
    partial = torch.sum(recv.to(torch.float32) * scales.reshape(d, 1),
                        dim=0) / d
    q2, s2 = quantize_int8(partial)
    allq = _all_gather(q2, group, d)                     # [d, n/d]
    alls = _all_gather(s2, group, d)                     # [d]
    out = (allq.to(torch.float32) * alls.reshape(d, 1)).reshape(-1)
    return out[:n].reshape(x.shape).to(x.dtype)
