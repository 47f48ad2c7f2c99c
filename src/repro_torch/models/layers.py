"""Layers of the port's decoder LM (the port of `repro.models.layers`, its
dense GQA part).

Attention paths:
  * prefill: the hand-written Hopper flash attention kernel
    (`repro_torch.kernels.flash_attention`), where the JAX package runs
    its XLA analogue `flash_xla.attend_flash`.  Activations stay
    [B, S, H, D] at the model's side; the kernel reads them through their
    strides as [B, H, S, D] views, so nothing is transposed in memory;
  * train: `flash_xla.attend_flash`, as in the JAX package: the same
    forward kernel with its lse, and the hand-written backward kernel;
  * decode: single-token attention over the cache, in plain PyTorch (the
    JAX package has no kernel there either).

Norms, rope and attention compute in f32 (in f64 for f64 activations, the
CPU route's float64 evaluation).  Sharding constraints use logical names
resolved by `repro_torch.launch.mesh.shard`: no-ops on one device, DTensor
redistributions under a mesh (there the attention kernels run on each
rank's local heads, `flash_xla.local_heads`).  MLA and cross-attention
wait for their architectures.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..launch import mesh as meshlib
from .flash_xla import attend_flash, local_heads
from .params import ParamSpec

shard = meshlib.shard

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def _acc(dtype):
    """The type a norm, rope or attention computes in: f32 or wider."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------- basics
def rms_norm(x, w, eps):
    xf = x.to(_acc(x.dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype)).to(x.dtype)


def norm_spec(d):
    return ParamSpec((d,), (None,), init="ones")


def rope(x, positions, theta):
    """x: [..., S, H, Dh] (Dh even); positions broadcastable to [..., S]."""
    half = x.shape[-1] // 2
    acc = _acc(x.dtype)
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=acc, device=x.device)
                             / half))
    ang = positions.to(acc)[..., None] * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def linear(p, x):
    y = x @ meshlib.gather_weight(p["w"]).to(x.dtype)
    if "b" in p:
        y = y + meshlib.gather_weight(p["b"]).to(x.dtype)
    return y


def linear_spec(d_in, d_out, in_ax, out_ax, *, bias=False):
    s = {"w": ParamSpec((d_in, d_out), (in_ax, out_ax))}
    if bias:
        s["b"] = ParamSpec((d_out,), (out_ax,), init="zeros")
    return s


# ------------------------------------------------------------------ MLP
def mlp_specs(cfg):
    return {"gate_up": linear_spec(cfg.d_model, 2 * cfg.d_ff, "embed",
                                   "mlp"),
            "down": linear_spec(cfg.d_ff, cfg.d_model, "mlp", "embed")}


def _gate_up(p, x):
    """(gate, up): x times the two column halves of ``p["w"]``.  Under a
    mesh the weight's model axis leaves gate column j and up column j on
    different ranks.  Where a rank holds more tokens than the weight has
    rows (training, prefill), the weight is regrouped as [d, 2, F] split
    over F (one all-gather of the weight, which its backward
    reduce-scatters) and each rank multiplies its own F columns of both
    halves; otherwise (decode) the product's halves are regrouped, the
    smaller move."""
    w = p["w"]
    if not meshlib.is_dtensor(w) or "b" in p or (
            math.prod(x.to_local().shape[:-1]) <= w.shape[0]):
        return linear(p, x).chunk(2, dim=-1)
    from torch.distributed.tensor import Shard
    w = meshlib.gather_weight(w)
    mesh = w.device_mesh
    split = [i for i, q in enumerate(w.placements) if q == Shard(1)]
    w = meshlib.gather_dim(w, 1)
    d, f = w.shape[0], w.shape[1] // 2
    w = w.view(d, 2, f)
    if split and f % math.prod(mesh.size(i) for i in split) == 0:
        w = w.redistribute(mesh, [Shard(2) if i in split else q
                                  for i, q in enumerate(w.placements)])
    return x @ w[:, 0].to(x.dtype), x @ w[:, 1].to(x.dtype)


def apply_mlp(p, x):
    gate, up = _gate_up(p["gate_up"], x)
    h = shard(F.silu(gate) * up, "act_batch", "act_seq", "act_mlp")
    out = linear(p["down"], h)
    if out.ndim == 3:  # pin the residual delta (reduce-scatter, not AR)
        out = shard(out, "act_batch", "act_seq", "act_embed")
    return out


# -------------------------------------------------------- attention core
def attend_decode(q, k_cache, v_cache, *, window, softcap, index):
    """One-token attention over the cache. q: [B,1,H,D]; caches [B,S,Hkv,D]."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    acc = _acc(q.dtype)
    # under a mesh the one token's heads are gathered (a few KB), so the
    # heads regroup by kv head while the cache stays split by sequence
    q = meshlib.gather_dim(q, 2)
    qg = q.reshape(b, hkv, h // hkv, d).to(acc)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(acc)) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kp = torch.arange(skv, device=q.device)
    valid = kp <= index
    if window is not None:
        valid &= (index - kp) < window
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(acc))
    return o.reshape(b, 1, h, d).to(q.dtype)


def _write_rows(cache, new, index: int) -> None:
    """``cache[:, index:index + S] = new``, in place.  A DTensor cache whose
    sequence the mesh splits is written on the rank that holds those rows,
    in its local shard (``new`` first takes the cache's other
    placements): no collective and no second cache, as the reference's
    donated dynamic_update_slice."""
    if not meshlib.is_dtensor(cache):
        cache[:, index:index + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    want = [Replicate() if p == Shard(1) else p for p in cache.placements]
    if list(new.placements) != want:
        new = new.redistribute(mesh, want)
    s0 = meshlib.local_offset(1, cache.shape[1], mesh, cache.placements)
    local, rows = cache.to_local(), new.to_local()
    lo, hi = max(index, s0), min(index + rows.shape[1], s0 + local.shape[1])
    if lo < hi:
        local[:, lo - s0:hi - s0] = rows[:, lo - index:hi - index]


# ------------------------------------------------------------------ GQA
def gqa_specs(cfg):
    h, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear_spec(d, h * hd, "embed", "qkv", bias=cfg.qkv_bias),
            "wk": linear_spec(d, hkv * hd, "embed", "kv", bias=cfg.qkv_bias),
            "wv": linear_spec(d, hkv * hd, "embed", "kv", bias=cfg.qkv_bias),
            "wo": linear_spec(h * hd, d, "qkv", "embed")}


def apply_gqa(p, x, cfg, *, kind, layer_kind, positions, cache=None,
              index=None):
    """kind: train|prefill|decode. Returns (out, new_cache); train returns
    no cache.

    Decode writes this token's k and v into ``cache`` in place at
    ``index`` (a Python int) and returns the same tensors."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.local_window if layer_kind == "local" else None
    split = meshlib.split_last
    q = rope(split(linear(p["wq"], x), h, hd), positions, cfg.rope_theta)
    k = rope(split(linear(p["wk"], x), hkv, hd), positions, cfg.rope_theta)
    v = split(linear(p["wv"], x), hkv, hd)
    q = shard(q, "act_batch", "act_seq", "act_heads", None)
    k = shard(k, "act_batch", "act_seq", "act_kv_heads", None)
    if kind == "decode":
        k_cache, v_cache = cache["k"], cache["v"]
        _write_rows(k_cache, k, index)
        _write_rows(v_cache, v, index)
        o = attend_decode(q, k_cache, v_cache, window=window,
                          softcap=cfg.attn_softcap, index=index)
        new_cache = {"k": k_cache, "v": v_cache}
    elif kind == "prefill":
        def prefill_attention(q, k, v):
            return flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, window=window,
                softcap=cfg.attn_softcap).transpose(1, 2)
        o = local_heads(prefill_attention, q, k, v)
        new_cache = {"k": k, "v": v}
    elif kind == "train":
        o = attend_flash(q, k, v, causal=True, window=window,
                         softcap=cfg.attn_softcap)
        new_cache = None
    else:
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    o = shard(o, "act_batch", "act_seq", "act_heads", None)
    return linear(p["wo"], o.reshape(b, s, h * hd)), new_cache
