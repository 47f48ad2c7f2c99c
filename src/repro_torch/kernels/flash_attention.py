"""Flash attention forward as hand-written Hopper kernels, with their plain
PyTorch version.

Port of `repro.kernels.flash_attention._kernel` (reached through
`flash_attention`): causal, GQA (q-head groups share a kv head),
sliding-window (gemma2 local layers), logit soft-capping (gemma2) and
right-aligned queries (Sq <= Skv), in f32 and bf16, accumulating in f32
(the plain version also takes f64 and then computes in f64: the CPU
route's float64 evaluation, a numerical reference).
Unlike the Pallas wrapper it takes any Sq and Skv, not only multiples of
the tiles: prompts come in every length.

The kernels read q, k and v through their strides (the last dim must be
contiguous), so the model hands them ``[B, S, H, D]`` activations viewed as
``[B, H, S, D]`` with no copy, and the output takes q's layout.

Routing is by dtype (`kernel_route`), with no fallback between routes:

- bf16 -> ``csrc/flash_attention_sm90.cu``: the tensor cores through
  wgmma, tiles through TMA.  TMA needs q, k and v 16-byte aligned and their
  (batch, head, seq) strides multiples of 16 bytes (`tma_strides`); a bf16
  input that breaks this raises ValueError, it is not sent elsewhere.
- f32 -> ``csrc/flash_attention.cu``: the CUDA cores in full f32 (the f32
  tolerance of 2e-5 rules out a bf16 P and TF32).

Each is built at first use by `_build`.  On a CUDA tensor the wrapper
launches one of them or raises; only a tensor on the CPU takes the plain
version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .ref import attention_mask

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (16, 32, 64, 128, 256)  # head_dims the kernels are built for
MAX_TILE = 64  # the f32 kernel's largest query and kv tiles
# the CUDA library (and its entry point) that each dtype launches
ROUTES = {torch.bfloat16: ("flash_attention_sm90", "flash_attention_fwd_sm90"),
          torch.float32: ("flash_attention", "flash_attention_fwd")}
TMA_ALIGN = 16  # bytes: TMA's alignment of base addresses and strides
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _check(q, k, v, causal, window, softcap, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D]")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads are not a multiple "
                         f"of {hkv} kv heads")
    if sq > skv:
        raise ValueError(f"flash_attention: Sq={sq} exceeds Skv={skv}")
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
                          block_k: int = 128):
    """The kernel's function in plain PyTorch ops, logits materialized:
    same arguments, same masking and empty-row rule (output 0).  Used by
    the CPU route and as the card's comparison."""
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
                          device=q.device)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    return (torch.matmul(p, vv) / l).to(q.dtype)


def kernel_route(dtype) -> str:
    """The CUDA library that a call in ``dtype`` launches: bf16 the wgmma
    kernel (``flash_attention_sm90``), f32 the CUDA-core kernel
    (``flash_attention``).  Any other dtype has no kernel and raises."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: no kernel for {dtype}")
    return ROUTES[dtype][0]


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = None,
                    softcap: float = None, scale: float = None,
                    block_q: int = 128, block_k: int = 128):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; Hq % Hkv == 0, Sq <= Skv.

    Returns [B, Hq, Sq, D] in q's dtype and layout.  ``scale`` defaults to
    1/sqrt(D).  ``block_q``/``block_k`` are validated on every route; on the
    f32 route they bound the kernel's query and kv tiles, which are at most
    `MAX_TILE` (the tile sizes change only the order of the f32 sums); the
    bf16 kernel uses its own tiles, 128 query rows (two wgmma tiles of 64)
    by 64 keys.  D must be one of `HEAD_DIMS`, and B * Hq at most 65535
    (the grid's second axis): a launch the card refuses raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     block_q=block_q, block_k=block_k)
    _check(q, k, v, causal, window, softcap, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, hq, sq, d = q.shape
    route = kernel_route(q.dtype)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    check = tma_strides if route == "flash_attention_sm90" else _strides
    dims = [b, hq, k.shape[1], sq, k.shape[2], d]
    for t in (q, k, v):
        dims += check(t)
    out = torch.empty_like(q)  # q's layout when q is dense, else row-major
    dims += _strides(out)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    args = [int(causal), int(window is not None),
            int(window) if window is not None else 0,
            int(softcap is not None),
            float(softcap) if softcap is not None else 0.0, float(scale)]
    if route == "flash_attention":
        args += [min(int(block_q), MAX_TILE), min(int(block_k), MAX_TILE)]
    from ._build import load
    entry = getattr(load(route), ROUTES[q.dtype][1])
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = entry(*(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)),
                    (ctypes.c_longlong * len(dims))(*dims), *args, stream)
    if err == -2:
        raise ValueError("flash_attention: cuTensorMapEncodeTiled refused "
                         "the TMA tensor map of q, k or v")
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches made through the wrapper
