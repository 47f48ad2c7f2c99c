"""Layers of the port's LMs (the port of `repro.models.layers`: dense GQA,
MLA, and the encoder-decoder's cross-attention).

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

MLA (multi-head latent attention, minicpm3) takes the same paths in its
expanded form for train and prefill, k and v of every head materialized
from the latent: q and k are nope + rope wide, v narrower, and the
kernels take that (D, Dv) pair.  Its decode runs the absorbed form over
the compressed cache (c_kv and the shared rope key), in plain PyTorch as
the reference's plain jnp.

Norms, rope and attention compute in f32 (in f64 for f64 activations, the
CPU route's float64 evaluation).  Sharding constraints use logical names
resolved by `repro_torch.launch.mesh.shard`: no-ops on one device, DTensor
redistributions under a mesh (there the attention kernels run on each
rank's local heads, `flash_xla.local_heads`).

A ``bidir`` layer (the encoder's) attends without the causal mask.
Cross-attention (`apply_cross_attn`) is full multi-head attention of the
decoder's queries over the encoder's memory (or over the cache's ``xk``
and ``xv`` at decode), with no rope and no bias: every call non-causal
through the kernels, Sq (the decoder's positions) above or below Skv (the
frames), the decode's single query included.
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
def mlp_specs(cfg, d_ff=None):
    """A gated MLP of width ``d_ff`` (default the config's; an MoE's shared
    experts take d_ff times their count)."""
    d_ff = d_ff or cfg.d_ff
    return {"gate_up": linear_spec(cfg.d_model, 2 * d_ff, "embed", "mlp"),
            "down": linear_spec(d_ff, cfg.d_model, "mlp", "embed")}


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


def _prefill_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Prefill attention (causal unless asked) through the forward kernel
    (no lse) on [B, S, H, D] activations viewed as [B, H, S, D], on each
    rank's local heads under a mesh; v may be narrower than q and k
    (MLA)."""
    def attend(q, k, v):
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, softcap=softcap).transpose(1, 2)
    return local_heads(attend, q, k, v)


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
    no cache.  A ``bidir`` layer (the encoder's) is not causal.

    Decode writes this token's k and v into ``cache`` in place at
    ``index`` (a Python int) and returns the same tensors."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.local_window if layer_kind == "local" else None
    causal = layer_kind != "bidir"
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
        o = _prefill_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_softcap)
        new_cache = {"k": k, "v": v}
    elif kind == "train":
        o = attend_flash(q, k, v, causal=causal, window=window,
                         softcap=cfg.attn_softcap)
        new_cache = None
    else:
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    o = shard(o, "act_batch", "act_seq", "act_heads", None)
    return linear(p["wo"], meshlib.merge_last(o, h, hd)), new_cache


def cross_attn_specs(cfg):
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    return {"wq": linear_spec(d, h * hd, "embed", "qkv"),
            "wk": linear_spec(d, h * hd, "embed", "qkv"),
            "wv": linear_spec(d, h * hd, "embed", "qkv"),
            "wo": linear_spec(h * hd, d, "qkv", "embed")}


def apply_cross_attn(p, x, memory, cfg, *, kind, cache=None):
    """Encoder-decoder cross-attention of ``x`` [B, S, D] over ``memory``
    [B, Sm, D] (the encoder's output), or over ``cache``'s ``xk``/``xv``
    [B, Sm, H, hd] when it holds them (decode).  Returns (out, new_cache):
    prefill's cache is {"xk", "xv"}, train and decode return none (the
    decode's is static after prefill).  Every call is non-causal through
    the kernels: train through `attend_flash` (with its gradient, dk and
    dv flowing into the memory), prefill and decode through the forward
    kernel."""
    h, hd = cfg.num_heads, cfg.head_dim
    split = meshlib.split_last
    q = shard(split(linear(p["wq"], x), h, hd), "act_batch", "act_seq",
              "act_heads", None)
    if cache is not None and "xk" in cache:
        k, v = cache["xk"], cache["xv"]
    else:
        k = split(linear(p["wk"], memory), h, hd)
        v = split(linear(p["wv"], memory), h, hd)
    if kind == "train":
        o = attend_flash(q, k, v, causal=False, window=None, softcap=None)
    elif kind in ("prefill", "decode"):
        o = _prefill_attention(q, k, v, causal=False)
    else:
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")
    new_cache = {"xk": k, "xv": v} if kind == "prefill" else None
    return linear(p["wo"], meshlib.merge_last(o, h, hd)), new_cache


# ------------------------------------------------------------------ MLA
def mla_specs(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    r, nd, vd = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    s = {"wkv_a": linear_spec(d, cfg.kv_lora_rank + r, "embed", "kv"),
         "kv_norm": norm_spec(cfg.kv_lora_rank),
         "wkv_b": linear_spec(cfg.kv_lora_rank, h * (nd + vd), "kv", "qkv"),
         "wo": linear_spec(h * vd, d, "qkv", "embed")}
    if cfg.q_lora_rank:
        s["wq_a"] = linear_spec(d, cfg.q_lora_rank, "embed", None)
        s["q_norm"] = norm_spec(cfg.q_lora_rank)
        s["wq_b"] = linear_spec(cfg.q_lora_rank, h * (nd + r), None, "qkv")
    else:
        s["wq"] = linear_spec(d, h * (nd + r), "embed", "qkv")
    return s


def _mla_q(p, x, cfg, positions):
    b, s, _ = x.shape
    h, r, nd = cfg.num_heads, cfg.rope_head_dim, cfg.nope_head_dim
    if cfg.q_lora_rank:
        qa = rms_norm(linear(p["wq_a"], x), p["q_norm"], cfg.norm_eps)
        q = linear(p["wq_b"], qa)
    else:
        q = linear(p["wq"], x)
    q = meshlib.split_last(q, h, nd + r)
    return q[..., :nd], rope(q[..., nd:], positions, cfg.rope_theta)


def apply_mla(p, x, cfg, *, kind, positions, cache=None, index=None):
    """DeepSeek-style multi-head latent attention (the reference's
    `apply_mla`).  kind: train|prefill|decode; returns (out, new_cache).

    The cache holds the compressed kv (``c_kv`` [B, S, kv_lora]) and the
    rope key shared by the heads (``k_rope`` [B, S, r]).  Train and
    prefill materialize each head's k = (k_nope, k_rope) and v from the
    latent and attend through the kernels at (D, Dv) = (nd + r, vd);
    decode writes this token's latent and rope key into ``cache`` in
    place at ``index`` and scores the absorbed way, q_nope W_uk against
    the latent, with logits scaled by 1/sqrt(nd + r)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    r, nd, vd = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank

    kv_a = linear(p["wkv_a"], x)                      # [b, s, lora + r]
    c_kv = rms_norm(kv_a[..., :lora], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, lora:], positions, cfg.rope_theta)[:, :, 0]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)

    wkv_b = meshlib.split_last(meshlib.gather_weight(p["wkv_b"]["w"]), h,
                               nd + vd)
    w_uk = wkv_b[..., :nd]                            # [lora, h, nd]
    w_uv = wkv_b[..., nd:]                            # [lora, h, vd]

    if kind == "decode":
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        _write_rows(c_cache, c_kv, index)
        _write_rows(r_cache, k_rope, index)
        acc = _acc(x.dtype)
        # absorbed: score = (q_nope W_uk) . c  +  q_rope . k_rope
        q_abs = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].to(acc),
                             w_uk.to(acc))
        s_nope = torch.einsum("bhl,bsl->bhs", q_abs, c_cache.to(acc))
        s_rope = torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(acc),
                              r_cache.to(acc))
        logits = (s_nope + s_rope) / math.sqrt(nd + r)
        kp = torch.arange(c_cache.shape[1], device=x.device)
        logits = torch.where(kp <= index, logits, _NEG)
        pr = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhs,bsl->bhl", pr, c_cache.to(acc))
        o = torch.einsum("bhl,lhv->bhv", ctx, w_uv.to(acc))
        if meshlib.is_dtensor(o):
            # the one token's heads whole and summed on every rank (its
            # batch split kept), as GQA's decode gathers them
            from torch.distributed.tensor import Replicate
            o = o.redistribute(o.device_mesh, [
                q if q.is_shard(0) else Replicate() for q in o.placements])
        o = o.reshape(b, 1, h * vd).to(x.dtype)
        new_cache = {"c_kv": c_cache, "k_rope": r_cache}
    else:
        # expanded: each head's k_nope and v materialized from the latent
        # (as products of [B, S, lora] by [lora, H * width]: dense [B, S, H,
        # width] results, which the kernels read through their strides)
        split = meshlib.split_last
        k_nope = split(c_kv @ w_uk.reshape(lora, h * nd).to(c_kv.dtype), h,
                       nd)
        v = split(c_kv @ w_uv.reshape(lora, h * vd).to(c_kv.dtype), h, vd)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, r)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        q = shard(q, "act_batch", "act_seq", "act_heads", None)
        if kind == "prefill":
            o = _prefill_attention(q, k, v)
            new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        elif kind == "train":
            o = attend_flash(q, k, v, causal=True, window=None, softcap=None)
            new_cache = None
        else:
            raise ValueError(f"kind must be train, prefill or decode, got "
                             f"{kind!r}")
        o = meshlib.merge_last(o, h, vd)
    return linear(p["wo"], o), new_cache
