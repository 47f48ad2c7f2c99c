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
CPU route's float64 evaluation).  The JAX package's sharding constraints
have nothing to do on one card and are left out; MLA and cross-attention
wait for their architectures.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .flash_xla import attend_flash
from .params import ParamSpec

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
    return ParamSpec((d,), init="ones")


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
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def linear_spec(d_in, d_out, *, bias=False):
    s = {"w": ParamSpec((d_in, d_out))}
    if bias:
        s["b"] = ParamSpec((d_out,), init="zeros")
    return s


# ------------------------------------------------------------------ MLP
def mlp_specs(cfg):
    return {"gate_up": linear_spec(cfg.d_model, 2 * cfg.d_ff),
            "down": linear_spec(cfg.d_ff, cfg.d_model)}


def apply_mlp(p, x):
    gate, up = linear(p["gate_up"], x).chunk(2, dim=-1)
    return linear(p["down"], F.silu(gate) * up)


# -------------------------------------------------------- attention core
def attend_decode(q, k_cache, v_cache, *, window, softcap, index):
    """One-token attention over the cache. q: [B,1,H,D]; caches [B,S,Hkv,D]."""
    b, _, h, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    acc = _acc(q.dtype)
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


# ------------------------------------------------------------------ GQA
def gqa_specs(cfg):
    h, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear_spec(d, h * hd, bias=cfg.qkv_bias),
            "wk": linear_spec(d, hkv * hd, bias=cfg.qkv_bias),
            "wv": linear_spec(d, hkv * hd, bias=cfg.qkv_bias),
            "wo": linear_spec(h * hd, d)}


def apply_gqa(p, x, cfg, *, kind, layer_kind, positions, cache=None,
              index=None):
    """kind: train|prefill|decode. Returns (out, new_cache); train returns
    no cache.

    Decode writes this token's k and v into ``cache`` in place at
    ``index`` (a Python int) and returns the same tensors."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.local_window if layer_kind == "local" else None
    q = rope(linear(p["wq"], x).reshape(b, s, h, hd), positions,
             cfg.rope_theta)
    k = rope(linear(p["wk"], x).reshape(b, s, hkv, hd), positions,
             cfg.rope_theta)
    v = linear(p["wv"], x).reshape(b, s, hkv, hd)
    if kind == "decode":
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, index:index + s] = k
        v_cache[:, index:index + s] = v
        o = attend_decode(q, k_cache, v_cache, window=window,
                          softcap=cfg.attn_softcap, index=index)
        new_cache = {"k": k_cache, "v": v_cache}
    elif kind == "prefill":
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True, window=window,
                            softcap=cfg.attn_softcap).transpose(1, 2)
        new_cache = {"k": k, "v": v}
    elif kind == "train":
        o = attend_flash(q, k, v, causal=True, window=window,
                         softcap=cfg.attn_softcap)
        new_cache = None
    else:
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    return linear(p["wo"], o.reshape(b, s, h * hd)), new_cache
