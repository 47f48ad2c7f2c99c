"""Flash attention forward as hand-written Hopper kernels, with their plain
PyTorch version.

Port of `repro.kernels.flash_attention._kernel` (reached through
`flash_attention`): causal, GQA (q-head groups share a kv head),
sliding-window (gemma2 local layers), logit soft-capping (gemma2) and
right-aligned queries (a causal call needs Sq <= Skv; a non-causal one,
as cross-attention, takes any Sq and Skv), in f32 and bf16, accumulating
in f32
(the plain version also takes f64 and then computes in f64: the CPU
route's float64 evaluation, a numerical reference).
Unlike the Pallas wrapper it takes any Sq and Skv, not only multiples of
the tiles: prompts come in every length.  v may have a head_dim of its own
(Dv, as the reference's XLA attention carries it): multi-head latent
attention's q and k are nope + rope wide, its v narrower.  The kernels are
built for the (D, Dv) pairs of `HEAD_DIMS`: the square ones in
``csrc/<name>.cu``, MLA's in ``csrc/<name>_mla.cu`` (`library`).

The kernels read q, k and v through their strides (the last dim must be
contiguous), so the model hands them ``[B, S, H, D]`` activations viewed as
``[B, H, S, D]`` with no copy, and the output takes q's layout.

Routing is by dtype (`kernel_route`), with no fallback between routes:

- bf16 -> ``csrc/flash_attention_sm90.cu``: the tensor cores through
  wgmma, tiles through TMA.  TMA needs q, k and v 16-byte aligned and their
  (batch, head, seq) strides multiples of 16 bytes (`tma_strides`); a bf16
  input that breaks this raises ValueError, it is not sent elsewhere.
- f32 -> ``csrc/flash_attention.cu``: the tensor cores through
  ``mma.sync`` in 3xTF32 (each f32 operand split into two TF32 parts,
  three TF32 products a product: within 2^-22 of f32's, so the f32
  tolerance of 2e-5 holds where one TF32 product would not); any strides
  with a contiguous head_dim (16-byte copies where they allow, else
  4-byte ones).

Each is built at first use by `_build`.  On a CUDA tensor the wrapper
launches one of them or raises; only a tensor on the CPU takes the plain
version.

For training, both forward kernels also write the rows' log-sum-exp
(``return_lse``: f32 [B, Hq, Sq], +BIG for a row with no key, as
`repro.models.flash_xla._fwd_impl` has it), and `flash_attention_bwd`
computes dq, dk and dv from (q, k, v, o, lse, dO), routed by dtype
(`bwd_kernel_route`) as the forward is:

- bf16 -> ``csrc/flash_attention_bwd_sm90.cu``: the tensor cores through
  wgmma, tiles through TMA, laid out by the pure-Python
  `bwd_launch_plan`; q, k, v and dO pass `tma_strides`.
- f32 -> ``csrc/flash_attention_bwd.cu``: the tensor cores in 3xTF32, as
  the f32 forward.

The JAX package differentiates its XLA attention
(`repro.models.flash_xla._bwd_rule`); its steps are the plain versions
here: `flash_attention_fwd_plain` (``_fwd_impl``) and
`flash_attention_bwd_plain` (``_bwd_rule``).  ``q_offset`` places query
row i at position i + q_offset (default Skv - Sq: right-aligned).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from torch.utils.flop_counter import register_flop_formula

from .ref import attention_mask

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
# the (q/k head_dim, v head_dim) pairs the kernels are built for: the
# square ones (zamba2's 112 among them, padded to 128 columns in the bf16
# kernels' shared memory), and MLA's (minicpm3-4b's 96 = 64 nope + 32 rope
# over a v of 64, its smoke configuration's 24 over 16, and
# deepseek-v2-lite's 192 = 128 nope + 64 rope over a v of 128), whose
# kernels build into the libraries' ``_mla`` twins
SQUARE_DIMS = (16, 32, 64, 112, 128, 256)
MLA_DIMS = ((96, 64), (24, 16), (192, 128))
HEAD_DIMS = tuple((d, d) for d in SQUARE_DIMS) + MLA_DIMS
# the CUDA library (and its entry point) that each dtype launches
ROUTES = {torch.bfloat16: ("flash_attention_sm90", "flash_attention_fwd_sm90"),
          torch.float32: ("flash_attention", "flash_attention_fwd")}
TMA_ALIGN = 16  # bytes: TMA's alignment of base addresses and strides
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
BIG = -_NEG  # the lse of a row with no key: its p is exp(s - BIG) = 0
# the CUDA library (and its entry point) that each dtype's backward launches
BWD_ROUTES = {torch.bfloat16: ("flash_attention_bwd_sm90",
                               "flash_attention_bwd_sm90"),
              torch.float32: ("flash_attention_bwd", "flash_attention_bwd")}
# the bf16 backward's tiles: a dk/dv block takes 64 keys and visits query
# tiles of 64 rows; a dq block takes 128 query rows and visits kv tiles of
# 32 keys; the scratch's rows are padded to 128
BWD_KEYS, BWD_QUERIES, BWD_ROWS, BWD_DQ_KEYS = 64, 64, 128, 32
_UNBOUNDED = 1 << 30  # a range bound that the mask does not set


def _check(q, k, v, causal, window, softcap, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple "
                         f"of {hkv} kv heads")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal Sq={sq} exceeds "
                         f"Skv={skv}")
    if (q.dtype not in _PLAIN_DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash_attention: q, k, v must share one of "
                         f"{list(_PLAIN_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one device")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap} must be > 0")
    if window is not None and int(window) != window:
        raise ValueError(f"flash_attention: window={window} must be an int")
    if block_q < 1 or block_k < 1:
        raise ValueError("flash_attention: block sizes must be >= 1")


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          softcap=None, scale=None, block_q: int = 128,
                          block_k: int = 128, q_offset=None):
    """The kernel's function in plain PyTorch ops, logits materialized:
    same arguments, same masking and empty-row rule (output 0), an output
    of v's head_dim.  Used by the CPU route and as the card's
    comparison."""
    _check(q, k, v, causal, window, softcap, block_q, block_k)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    kk = k.to(acc).repeat_interleave(hq // hkv, dim=1)
    vv = v.to(acc).repeat_interleave(hq // hkv, dim=1)
    s = torch.matmul(q.to(acc), kk.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    return (torch.matmul(p, vv) / l).to(q.dtype)


def _grouped(t, hkv, acc):
    """[B, H, S, D] -> [B, Hkv, g, S, D] in the type ``acc``: the JAX
    package's ``[b, hkv, g, sq, d]`` layout, q head h = kv head * g + j."""
    b, h, s, d = t.shape
    return t.reshape(b, hkv, h // hkv, s, d).to(acc)


def _chunking(q, k, scale, chunk):
    """The reference's kv chunk (all of Skv unless ``chunk`` divides it),
    the scale and the accumulation type."""
    skv, d = k.shape[2], q.shape[3]
    chunk = min(chunk, skv)
    if skv % chunk:
        chunk = skv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    return chunk, scale, torch.promote_types(q.dtype, torch.float32)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True, window=None,
                              softcap=None, scale=None, q_offset=None,
                              chunk: int = 512):
    """Returns (o, lse): `repro.models.flash_xla._fwd_impl` step for step
    (online softmax over kv chunks), in the kernel's [B, H, S, D] layout.
    lse is [B, Hq, Sq] in the accumulation type (f32, or f64 for f64
    inputs), +BIG for a row with no key.  Used by the CPU route of
    ``return_lse`` and as the card's comparison of the kernels' lse.  o
    has v's head_dim."""
    _check(q, k, v, causal, window, softcap, 1, 1)
    b, hq, sq, _ = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    chunk, scale, acc = _chunking(q, k, scale, chunk)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    qg = _grouped(q, hkv, acc)
    g = hq // hkv
    m = torch.full((b, hkv, g, sq), _NEG, dtype=acc, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=acc, device=q.device)
    a = torch.zeros((b, hkv, g, sq, dv), dtype=acc, device=q.device)
    for c0 in range(0, skv, chunk):
        kb = k[:, :, c0:c0 + chunk].to(acc)
        vb = v[:, :, c0:c0 + chunk].to(acc)
        mc = mask[:, c0:c0 + chunk]
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kb) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mc, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mc, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        a = a * alpha[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, vb)
        m = m_new
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)), BIG)
    o = a / torch.clamp(l, min=1e-37)[..., None]
    return (o.reshape(b, hq, sq, dv).to(q.dtype), lse.reshape(b, hq, sq))


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window=None, softcap=None, scale=None,
                              q_offset=None, chunk: int = 512):
    """Returns (dq, dk, dv): `repro.models.flash_xla._bwd_rule` step for
    step, in the kernel's [B, H, S, D] layout: delta = rowsum(dO * O); per
    kv chunk the logits recomputed, p = exp(s - lse) (0 where masked, and
    0 in a row whose lse is +BIG), dv = p^T dO, dp = dO v^T, ds = p (dp -
    delta), times (1 - t^2) under a softcap, times the scale; dq the sum
    over chunks of ds k, dk = ds^T q; dk and dv summed over the g q heads
    of a kv head.  o and dO have v's head_dim; dq, dk and dv take q's, k's
    and v's shapes.  The kernel's comparison on the card, and its CPU
    route."""
    _check(q, k, v, causal, window, softcap, 1, 1)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    chunk, scale, acc = _chunking(q, k, scale, chunk)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device=q.device, q_offset=q_offset)
    qg = _grouped(q, hkv, acc)
    dog = _grouped(do, hkv, acc)
    og = _grouped(o, hkv, acc)
    delta = torch.sum(dog * og, dim=-1)                # [b,hkv,g,sq]
    lse_g = lse.reshape(b, hkv, hq // hkv, sq).to(acc)
    dq = torch.zeros_like(qg)
    dk = torch.empty(b, hkv, skv, d, dtype=acc, device=q.device)
    dv = torch.empty(b, hkv, skv, v.shape[3], dtype=acc, device=q.device)
    for c0 in range(0, skv, chunk):
        kf = k[:, :, c0:c0 + chunk].to(acc)
        vf = v[:, :, c0:c0 + chunk].to(acc)
        mc = mask[:, c0:c0 + chunk]
        s_raw = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
        if softcap is not None:
            t = torch.tanh(s_raw / softcap)
            s = torch.where(mc, softcap * t, _NEG)
        else:
            s = torch.where(mc, s_raw, _NEG)
        p = torch.exp(s - lse_g[..., None])
        p = torch.where(mc, p, 0.0)
        dv[:, :, c0:c0 + chunk] = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
        dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
        ds = p * (dp - delta[..., None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq = dq + torch.einsum("bkgqs,bksd->bkgqd", ds, kf)
        dk[:, :, c0:c0 + chunk] = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def kernel_route(dtype, d=None, dv=None) -> str:
    """The CUDA library that a call in ``dtype`` launches: bf16 the wgmma
    kernel (``flash_attention_sm90``), f32 the 3xTF32 kernel
    (``flash_attention``); with a (``d``, ``dv``) head_dim pair, the
    library that pair is built in (`library`).  Any other dtype has no
    kernel and raises."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: no kernel for {dtype}")
    if d is None:
        return ROUTES[dtype][0]
    return library(ROUTES[dtype], d, dv)[0]


def library(route, d: int, dv: int) -> tuple:
    """(library, entry point) of ``route`` (an entry of `ROUTES` or
    `BWD_ROUTES`) for q/k head_dim ``d`` and v head_dim ``dv``: MLA's
    pairs are built in the ``_mla`` twin of each library.  A pair that is
    not in `HEAD_DIMS` raises ValueError naming the built pairs."""
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel is built for q/k "
                         f"head_dim {d} with v head_dim {dv}; built (D, Dv) "
                         f"pairs: {list(HEAD_DIMS)}")
    if (d, dv) in MLA_DIMS:
        return tuple(f"{name}_mla" for name in route)
    return tuple(route)


def _empty_as(t, last: int):
    """An empty tensor of ``t``'s shape with ``last`` in its last dim, its
    dims laid out in ``t``'s order (``t``'s layout when ``t`` is dense and
    ``last`` its own last dim)."""
    if t.shape[-1] == last:
        return torch.empty_like(t)
    n = t.dim() - 1
    order = sorted(range(n), key=lambda i: -t.stride(i)) + [n]
    out = t.new_empty([t.shape[i] for i in order[:n]] + [last])
    return out.permute([order.index(i) for i in range(n + 1)])


def _strides(t) -> list:
    """(batch, head, seq) element strides of a [B, H, S, D] tensor; a dim of
    size 1 is never stepped, so it takes its contiguous stride."""
    dense = [t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
             t.shape[3]]
    return [t.stride(i) if t.shape[i] > 1 else dense[i] for i in range(3)]


def tma_strides(t) -> list:
    """`_strides` of a tensor the bf16 kernel reads through TMA, after
    TMA's checks: base address and every stride a multiple of 16 bytes.
    Raises ValueError naming the rule that ``t`` breaks."""
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: the bf16 kernel's TMA loads need "
                         f"q, k, v {TMA_ALIGN}-byte aligned; data_ptr "
                         f"{t.data_ptr():#x} is not")
    strides = _strides(t)
    for name, st in zip(("batch", "head", "seq"), strides):
        if st * t.element_size() % TMA_ALIGN:
            raise ValueError(f"flash_attention: the bf16 kernel's TMA loads "
                             f"need strides that are multiples of "
                             f"{TMA_ALIGN} bytes; the {name} stride is "
                             f"{st * t.element_size()} bytes")
    return strides


def tma_loadable(t) -> bool:
    """Whether `tma_strides` takes ``t``."""
    try:
        tma_strides(t)
    except ValueError:
        return False
    return True


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _call(route: str, entry: str, device, *args) -> int:
    """One C entry point of a built library, on ``device``'s current
    stream; returns its error code."""
    from ._build import load
    fn = getattr(load(route), entry)
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        return fn(*args, stream)


def _window_args(causal, window, softcap, scale) -> list:
    return [int(causal), int(window is not None),
            int(window) if window is not None else 0,
            int(softcap is not None),
            float(softcap) if softcap is not None else 0.0, float(scale)]


def visible_pairs(sq: int, skv: int, *, causal: bool, window=None,
                  q_offset=None) -> int:
    """The (query, key) pairs `attention_mask` lets through, counted in
    closed form a row: the work of one (batch, head) of the kernels."""
    off = skv - sq if q_offset is None else int(q_offset)
    qpos = np.arange(sq, dtype=np.int64) + off
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = (np.maximum(qpos - int(window) + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention(q, k, v, *, causal: bool = True, window: int = None,
                    softcap: float = None, scale: float = None,
                    block_q: int = 128, block_k: int = 128, q_offset=None,
                    return_lse: bool = False):
    """q, k: [B, Hq, Sq, D], [B, Hkv, Skv, D]; v: [B, Hkv, Skv, Dv];
    Hq % Hkv == 0; a causal call needs Sq <= Skv (a non-causal one with
    no window sees every key whatever ``q_offset``).

    Returns [B, Hq, Sq, Dv] in q's dtype and layout, and with
    ``return_lse`` also the rows' log-sum-exp (f32 [B, Hq, Sq], +BIG for
    a row with no key).  ``scale`` defaults to 1/sqrt(D); ``q_offset``
    (default Skv - Sq) is the position of query row 0.
    ``block_q``/``block_k`` are validated on every route and change
    nothing: the kernels take their own tiles, bf16 128 query rows (two
    wgmma tiles of 64) by 64 keys, f32 128 query rows (16 a warp) by 16 to
    64 keys as its shared memory allows, or for Sq <= 16 (a decode step)
    one 16-row tile whose keys its warps share out
    (``csrc/flash_attention.cu``, ``Tiles``).  (D, Dv) must be one of
    `HEAD_DIMS` (on a CUDA tensor another pair raises ValueError), and
    B * Hq at most 65535 (the grid's second axis): a launch the card
    refuses raises.  ``scale`` defaults to 1/sqrt(D), of q and k, as the
    reference's.

    The call goes through the custom op ``repro_torch::flash_attention``
    (`torch.library.Library`; CPU: the plain version, CUDA: the
    kernel), whose fake implementation and FLOP formula (2 (D + Dv) a
    visible pair and head) let the dry-run trace it.
    """
    _check(q, k, v, causal, window, softcap, block_q, block_k)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    o, lse = torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), None if window is None else int(window),
        None if softcap is None else float(softcap),
        None if scale is None else float(scale), int(block_q), int(block_k),
        None if q_offset is None else int(q_offset), bool(return_lse))
    return (o, lse) if return_lse else o


def _fwd_cpu(q, k, v, causal, window, softcap, scale, block_q, block_k,
             q_offset, return_lse):
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if return_lse:
        return flash_attention_fwd_plain(q, k, v, **kw)
    return (flash_attention_plain(q, k, v, block_q=block_q, block_k=block_k,
                                  **kw),
            q.new_empty((0,), dtype=torch.float32))


def _fwd_fake(q, k, v, causal, window, softcap, scale, block_q, block_k,
              q_offset, return_lse):
    b, hq, sq, _ = q.shape
    if q.device.type == "cpu":  # the plain version's dense results
        o = q.new_empty((b, hq, sq, v.shape[3]))
        lse_dtype = torch.promote_types(q.dtype, torch.float32)
    else:
        o, lse_dtype = _empty_as(q, v.shape[3]), torch.float32
    return o, q.new_empty((b, hq, sq) if return_lse else (0,),
                          dtype=lse_dtype)


def _fwd_on_card(q, k, v, causal, window, softcap, scale, block_q,
                 block_k, q_offset, return_lse):
    """One launch of the forward kernel that ``q``'s dtype routes to;
    returns (out, lse), lse empty without ``return_lse``."""
    b, hq, sq, d = q.shape
    dv = v.shape[3]
    kernel_route(q.dtype)  # raises for a dtype with no kernel
    lib, entry = library(ROUTES[q.dtype], d, dv)
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    check = tma_strides if q.dtype == torch.bfloat16 else _strides
    dims = [b, hq, k.shape[1], sq, k.shape[2], d]
    for t in (q, k, v):
        dims += check(t)
    out = _empty_as(q, dv)  # q's layout when q is dense, else row-major
    dims += _strides(out) + [dv]
    lse = (torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    args = _window_args(causal, window, softcap, scale) + [
        k.shape[2] - sq if q_offset is None else int(q_offset), _ptr(lse)]
    err = _call(lib, entry, q.device,
                *(_ptr(t) for t in (q, k, v, out)),
                (ctypes.c_longlong * len(dims))(*dims), *args)
    if err == -2:
        raise ValueError("flash_attention: cuTensorMapEncodeTiled refused "
                         "the TMA tensor map of q, k or v")
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, (lse if return_lse else q.new_empty((0,),
                                                    dtype=torch.float32))


flash_attention.launches = 0  # kernel launches made through the wrapper


def bwd_kernel_route(dtype, d=None, dv=None) -> str:
    """The CUDA library that a backward call in ``dtype`` launches: bf16
    the wgmma kernel (``flash_attention_bwd_sm90``), f32 the 3xTF32
    kernel (``flash_attention_bwd``); with a (``d``, ``dv``) pair, the
    library that pair is built in.  Any other dtype raises."""
    if dtype not in BWD_ROUTES:
        raise ValueError(f"flash_attention_bwd: no kernel for {dtype}")
    if d is None:
        return BWD_ROUTES[dtype][0]
    return library(BWD_ROUTES[dtype], d, dv)[0]


def _tiles(lo, hi, tile: int):
    """(first start, count) of the tiles of ``tile`` that cut [lo, hi),
    the first at a multiple of ``tile``; (0, 0) where the range is empty.
    Element-wise on int64 arrays."""
    first = lo // tile * tile
    count = np.where(hi > lo, -(-(hi - first) // tile), 0)
    return np.where(count > 0, first, 0), count


@dataclass(frozen=True)
class BwdPlan:
    """How the bf16 backward's two kernels cover the visible (query, key)
    pairs.  The kernels read `blocks`: one row (head, start, first, tiles)
    a block.  A dk/dv block takes the keys [start, start + 64) of kv head
    ``head`` (b * Hkv + h) and visits, for each q head of the group,
    ``tiles`` query tiles of 64 rows from row ``first``; a dq block takes
    the rows [start, start + 128) of q head ``head`` (b * Hq + h) and
    visits ``tiles`` kv tiles of 32 keys from key ``first``.  A dk/dv
    block of keys [k0, k1) sees the rows [max(0, k0 + q_lo), min(Sq, k1 +
    q_hi)); a dq block of rows [i0, i1) the keys [max(0, i0 + k_lo),
    min(Skv, i1 + k_hi)).  ``window`` is the call's, clamped to where it
    still masks."""
    sq: int
    skv: int
    heads_kv: int
    heads_q: int
    kv_tiles: int
    q_tiles: int
    dq_reverse: bool
    q_lo: int
    q_hi: int
    k_lo: int
    k_hi: int
    sq_pad: int
    window: int
    q_offset: int

    def args(self) -> list:
        """The scalars of the plan as the kernel's entry point takes them."""
        return [self.dkdv_blocks, self.dq_blocks, self.sq_pad, self.window,
                self.q_offset]

    @property
    def dkdv_blocks(self) -> int:
        return self.kv_tiles * self.heads_kv

    @property
    def dq_blocks(self) -> int:
        return self.q_tiles * self.heads_q

    def blocks(self) -> np.ndarray:
        """int32 [dkdv_blocks + dq_blocks, 4]: the dk/dv kernel's blocks,
        then the dq kernel's, each in launch order, heaviest first: the
        head fastest, the lowest keys first, and under causal the last
        query tile first."""
        x = np.arange(self.dkdv_blocks, dtype=np.int64)
        k0 = x // self.heads_kv * BWD_KEYS
        k1 = np.minimum(k0 + BWD_KEYS, self.skv)
        dkdv = (x % self.heads_kv, k0) + _tiles(
            np.maximum(0, k0 + self.q_lo), np.minimum(self.sq, k1 + self.q_hi),
            BWD_QUERIES)
        x = np.arange(self.dq_blocks, dtype=np.int64)
        rank = x // self.heads_q
        i0 = (self.q_tiles - 1 - rank if self.dq_reverse else rank) * BWD_ROWS
        i1 = np.minimum(i0 + BWD_ROWS, self.sq)
        dq = (x % self.heads_q, i0) + _tiles(
            np.maximum(0, i0 + self.k_lo), np.minimum(self.skv, i1 + self.k_hi),
            BWD_DQ_KEYS)
        return np.concatenate([np.stack(dkdv, 1), np.stack(dq, 1)]).astype(
            np.int32).reshape(-1, 4)


def bwd_launch_plan(b: int, hq: int, hkv: int, sq: int, skv: int, *,
                    causal: bool, window=None, q_offset=None) -> BwdPlan:
    """The bf16 backward's grids, block order and tile ranges (see
    `BwdPlan`).  Pair (i, j) is visible when causal j <= i + off and
    window i + off - j < window (off = q_offset, default Skv - Sq), so a
    key range [k0, k1) sees rows i >= k0 - off and i < k1 + window - 1 -
    off, and a row range [i0, i1) keys j < i1 + off and j >= i0 + off -
    window + 1.  The tiles do not depend on the head dims: MLA's (D, Dv)
    pairs take the square ones' (their rings are narrower, see
    ``csrc/flash_attention_bwd_sm90.cu``)."""
    off = skv - sq if q_offset is None else int(q_offset)
    # qpos - kpos lies in [off - skv + 1, off + sq - 1]: a window outside
    # [off - skv, off + sq] masks as that bound does
    w = 0 if window is None else min(max(int(window), off - skv), off + sq)
    return BwdPlan(
        sq=sq, skv=skv, heads_kv=b * hkv, heads_q=b * hq,
        kv_tiles=-(-skv // BWD_KEYS), q_tiles=-(-sq // BWD_ROWS),
        dq_reverse=bool(causal),
        q_lo=-off if causal else -_UNBOUNDED,
        q_hi=w - 1 - off if window is not None else _UNBOUNDED,
        k_lo=off - w + 1 if window is not None else -_UNBOUNDED,
        k_hi=off if causal else _UNBOUNDED,
        sq_pad=-(-sq // BWD_ROWS) * BWD_ROWS, window=w, q_offset=off)


@functools.lru_cache(maxsize=64)
def _blocks_on(plan: BwdPlan, device) -> torch.Tensor:
    """`BwdPlan.blocks` on ``device``, copied there once a plan."""
    return torch.from_numpy(plan.blocks()).to(device)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = None, softcap: float = None,
                        scale: float = None, q_offset=None):
    """Gradients of `flash_attention`: returns (dq, dk, dv) in the layouts
    and dtypes of q, k and v, from the forward's inputs, its output ``o``
    and ``lse`` (f32 [B, Hq, Sq]) and the output's gradient ``do``, all
    [B, H, S, D] as the forward takes them (any strides with a
    contiguous head_dim; o and do of v's head_dim Dv).

    On a CUDA tensor ((D, Dv) one of `HEAD_DIMS`, else ValueError) it
    launches, by dtype
    (`bwd_kernel_route`), ``csrc/flash_attention_bwd_sm90.cu`` for bf16
    or ``csrc/flash_attention_bwd.cu`` for f32 (one call: the delta pass,
    the dk/dv pass and the dq pass), or raises; a bf16 q, k, v or do that
    TMA cannot load raises ValueError.  A CPU tensor takes
    `flash_attention_bwd_plain`.

    The call goes through the custom op ``repro_torch::flash_attention_bwd``
    (CPU: the plain version, CUDA: the kernel), whose fake implementation
    and FLOP formula (2 (3 D + 2 Dv) a visible pair and head) let the
    dry-run trace it.
    """
    _check(q, k, v, causal, window, softcap, 1, 1)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, o, lse, do, bool(causal),
        None if window is None else int(window),
        None if softcap is None else float(softcap),
        None if scale is None else float(scale),
        None if q_offset is None else int(q_offset))
    return dq, dk, dv


def _bwd_cpu(q, k, v, o, lse, do, causal, window, softcap, scale,
             q_offset):
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     window=window, softcap=softcap,
                                     scale=scale, q_offset=q_offset)


def _bwd_fake(q, k, v, o, lse, do, causal, window, softcap, scale,
              q_offset):
    if q.device.type == "cpu":  # the plain version's dense results
        return tuple(t.new_empty(t.shape) for t in (q, k, v))
    return tuple(torch.empty_like(t) for t in (q, k, v))


def _bwd_on_card(q, k, v, o, lse, do, causal, window, softcap, scale,
                 q_offset):
    """One call of the backward kernel that ``q``'s dtype routes to."""
    b, hq, sq, d = q.shape
    hkv, skv, dv_ = k.shape[1], k.shape[2], v.shape[3]
    if o.shape != (b, hq, sq, dv_) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be {(b, hq, sq, dv_)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous f32 "
                         f"[B, Hq, Sq] = {(b, hq, sq)} tensor")
    if q.dtype not in BWD_ROUTES or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: no kernel for q {q.dtype}, "
                         f"o {o.dtype}, do {do.dtype}")
    if any(t.device != q.device for t in (o, lse, do)) \
            or q.device.type != "cuda":
        raise ValueError("flash_attention_bwd: every tensor must lie on the "
                         "card that holds q")
    route, entry = library(BWD_ROUTES[q.dtype], d, dv_)
    if any(t.stride(3) != 1 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: the head_dim axis of every "
                         "input must be contiguous")
    sm90 = q.dtype == torch.bfloat16
    check = tma_strides if sm90 else _strides
    dims = [b, hq, hkv, sq, skv, d]
    for t in (q, k, v):
        dims += check(t)
    dims += _strides(o) + check(do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for t in (dq, dk, dv):
        dims += _strides(t)
    dims.append(dv_)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if sm90:  # the plan carries the clamped window and the offset
        plan = bwd_launch_plan(b, hq, hkv, sq, skv, causal=causal,
                               window=window, q_offset=q_offset)
        scratch = torch.empty(2, b * hq, plan.sq_pad, dtype=torch.float32,
                              device=q.device)  # lse2, delta
        blocks = _blocks_on(plan, q.device)
        # the cached table outlives this call: not freed under a stream
        # that may still read it
        blocks.record_stream(torch.cuda.current_stream(q.device))
        plan_args = plan.args()
        args = [_ptr(blocks), (ctypes.c_longlong * len(dims))(*dims),
                (ctypes.c_longlong * len(plan_args))(*plan_args), int(causal),
                int(window is not None), int(softcap is not None),
                float(softcap) if softcap is not None else 0.0, float(scale)]
    else:  # delta
        scratch = torch.empty(b, hq, sq, dtype=torch.float32,
                              device=q.device)
        args = [(ctypes.c_longlong * len(dims))(*dims)] + _window_args(
            causal, window, softcap, scale) + [
            skv - sq if q_offset is None else int(q_offset)]
    err = _call(route, entry, q.device,
                *(_ptr(t) for t in (q, k, v, o, lse, do, dq, dk, dv,
                                    scratch)), *args)
    if err == -2:
        raise ValueError("flash_attention_bwd: cuTensorMapEncodeTiled "
                         "refused the TMA tensor map of q, k, v or do")
    if err:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # kernel calls made through the wrapper


# the ops: a schema and one kernel a dispatch key, with no autograd
# wrapper (`models.flash_xla.FlashAttention` owns the gradient), so a call
# costs the dispatcher's few microseconds on the host and no more
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, float? softcap, float? scale, int block_q, "
            "int block_k, int? q_offset, bool return_lse) -> "
            "(Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor do, bool causal, int? window, "
            "float? softcap, float? scale, int? q_offset) -> "
            "(Tensor, Tensor, Tensor)")
for _name, _cpu, _cuda, _fake in (
        ("flash_attention", _fwd_cpu, _fwd_on_card, _fwd_fake),
        ("flash_attention_bwd", _bwd_cpu, _bwd_on_card, _bwd_fake)):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)


# the custom ops' FLOPs for `torch.utils.flop_counter` (and the dry-run's
# counter): the products over the visible pairs that row 4's and row 5's
# bounds count, 2 flops a pair per column of the product's k-extent
# (forward: QK^T over D and PV over Dv; backward: S, dQ and dK over D, dP
# and dV over Dv)
def fwd_flops(d: int, dv: int, pairs: int) -> int:
    """FLOPs of the forward over ``pairs`` visible (query, key) pairs."""
    return 2 * (d + dv) * pairs


def bwd_flops(d: int, dv: int, pairs: int) -> int:
    """FLOPs of the backward over ``pairs`` visible (query, key) pairs."""
    return 2 * (3 * d + 2 * dv) * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q, k, v, causal, window, softcap, scale, block_q, block_k,
               q_offset, return_lse, *, out_shape=None, **kwargs):
    b, hq, sq, d = q
    return fwd_flops(d, v[3], b * hq * visible_pairs(
        sq, k[2], causal=causal, window=window, q_offset=q_offset))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, o, lse, do, causal, window, softcap, scale,
               q_offset, *, out_shape=None, **kwargs):
    b, hq, sq, d = q
    return bwd_flops(d, v[3], b * hq * visible_pairs(
        sq, k[2], causal=causal, window=window, q_offset=q_offset))
