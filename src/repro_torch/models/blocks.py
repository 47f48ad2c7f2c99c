"""Per-layer blocks of the port (the port of `repro.models.blocks`):
dense/local/global and moe, each with GQA or MLA attention, an moe
block's MLP being `models.moe`; the encoder-decoder's bidir (the
encoder's non-causal layer) and xdec (the decoder's causal layer with
cross-attention over the encoder's memory); and the SSM kinds, ssm (a
Mamba2 mixer, `models.ssm`) and ssm_attn (the mixer, then zamba2's
weight-tied attention+MLP block, whose weights live outside the stacked
groups: `shared_block_specs`)."""
from __future__ import annotations

import torch

from . import layers, moe, ssm

ATTN_KINDS = ("dense", "local", "global", "bidir", "moe", "xdec")
ATTENTIONS = ("gqa", "mla")
SSM_KINDS = ("ssm", "ssm_attn")


def _check_kind(cfg, kind):
    if kind in SSM_KINDS:
        return
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; known: "
                         f"{ATTN_KINDS + SSM_KINDS}")
    if cfg.attention not in ATTENTIONS:
        raise ValueError(f"block kind {kind!r} needs one of {ATTENTIONS} "
                         f"attention, not {cfg.attention!r}")


def has_attention(kind) -> bool:
    """Whether a block of ``kind`` runs an attention forward (ssm_attn's
    is the shared block's)."""
    return kind != "ssm"


def block_specs(cfg, kind):
    _check_kind(cfg, kind)
    d = cfg.d_model
    if kind in SSM_KINDS:
        # ssm_attn: the mamba sublayer; the attention/MLP weights are
        # shared (`shared_block_specs`)
        return {"ln": layers.norm_spec(d), "ssm": ssm.ssm_specs(cfg)}
    if kind == "xdec":
        return {"ln_attn": layers.norm_spec(d), "attn": layers.gqa_specs(cfg),
                "ln_x": layers.norm_spec(d),
                "xattn": layers.cross_attn_specs(cfg),
                "ln_mlp": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}
    attn = layers.mla_specs(cfg) if cfg.attention == "mla" \
        else layers.gqa_specs(cfg)
    if kind == "moe":
        return {"ln_attn": layers.norm_spec(d), "attn": attn,
                "ln_mlp": layers.norm_spec(d), "moe": moe.moe_specs(cfg)}
    return {"ln_attn": layers.norm_spec(d), "attn": attn,
            "ln_mlp": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}


def shared_block_specs(cfg):
    """Zamba2-style weight-tied attention+MLP block."""
    d = cfg.d_model
    return {"ln_attn": layers.norm_spec(d), "attn": layers.gqa_specs(cfg),
            "ln_mlp": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}


def _apply_ssm_block(p, x, cfg, block_kind, *, kind, positions, cache,
                     index, shared):
    """An ssm block, and for ssm_attn the shared block after it: global
    GQA attention (its own ``shared_attn`` cache in each ssm_attn layer)
    and the MLP, as the reference applies them (no residual pin)."""
    h, c = ssm.apply_ssm(
        p["ssm"], layers.rms_norm(x, p["ln"], cfg.norm_eps), cfg, kind=kind,
        cache=None if cache is None else cache["ssm"])
    x = x + h
    new = {"ssm": c}
    if block_kind == "ssm_attn":
        sp = shared
        a, c = layers.apply_gqa(
            sp["attn"], layers.rms_norm(x, sp["ln_attn"], cfg.norm_eps), cfg,
            kind=kind, layer_kind="global", positions=positions,
            cache=None if cache is None else cache["shared_attn"],
            index=index)
        x = x + a
        new["shared_attn"] = c
        x = x + layers.apply_mlp(
            sp["mlp"], layers.rms_norm(x, sp["ln_mlp"], cfg.norm_eps))
    return x, new


def apply_block(p, x, cfg, block_kind, *, kind, positions, cache=None,
                index=None, shared=None, memory=None):
    """Returns (x, new_cache_for_this_block).  ``shared``: the shared
    block's parameters (an ssm_attn block's); ``memory``: the encoder's
    output [B, Sm, D] (an xdec block's, but at decode, where its
    cross-attention reads the cache's ``xattn``)."""
    _check_kind(cfg, block_kind)
    if block_kind in SSM_KINDS:
        return _apply_ssm_block(p, x, cfg, block_kind, kind=kind,
                                positions=positions, cache=cache,
                                index=index, shared=shared)
    h = layers.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    c = None if cache is None else cache["attn"]
    if cfg.attention == "mla" and block_kind != "bidir":
        a, c = layers.apply_mla(p["attn"], h, cfg, kind=kind,
                                positions=positions, cache=c, index=index)
    else:
        a, c = layers.apply_gqa(p["attn"], h, cfg, kind=kind,
                                layer_kind=block_kind, positions=positions,
                                cache=c, index=index)
    # pin the residual delta to the residual-stream sharding: the
    # row-parallel projection's partial sums are then reduce-scattered,
    # not all-reduced
    x = x + layers.shard(a, "act_batch", "act_seq", "act_embed")
    new = {"attn": c}
    if block_kind == "xdec":
        xc = None if cache is None else cache["xattn"]
        a, c = layers.apply_cross_attn(
            p["xattn"], layers.rms_norm(x, p["ln_x"], cfg.norm_eps), memory,
            cfg, kind=kind, cache=xc)
        x = x + a
        # static after prefill: decode hands the cache's through
        new["xattn"] = xc if kind == "decode" else c
    h = layers.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if block_kind == "moe":
        x = x + moe.apply_moe(p["moe"], h, cfg)
    else:
        x = x + layers.apply_mlp(p["mlp"], h)
    return x, new


def cache_struct(cfg, block_kind, batch: int, seq: int, dtype, device):
    """Zero-initialized cache tree for one block: k and v of every kv head
    (GQA), or MLA's compressed latent and shared rope key; an xdec block's
    also the cross-attention's ``xk``/``xv`` [B, source_len, H, hd]; an
    ssm block's state ``h`` (f32 whatever ``dtype``) and conv inputs, and
    an ssm_attn block's also the shared block's k and v."""
    _check_kind(cfg, block_kind)
    kv = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    if block_kind in SSM_KINDS:
        d_inner, nheads, n = ssm.ssm_dims(cfg)
        c = {"ssm": {
            "h": torch.zeros((batch, nheads, n, cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * n),
                                dtype=dtype, device=device)}}
        if block_kind == "ssm_attn":
            c["shared_attn"] = {name: torch.zeros(kv, dtype=dtype,
                                                  device=device)
                                for name in ("k", "v")}
        return c
    if cfg.attention == "mla":
        shapes = {"c_kv": (batch, seq, cfg.kv_lora_rank),
                  "k_rope": (batch, seq, cfg.rope_head_dim)}
    else:
        shapes = {"k": kv, "v": kv}
    c = {"attn": {name: torch.zeros(shape, dtype=dtype, device=device)
                  for name, shape in shapes.items()}}
    if block_kind == "xdec":
        xkv = (batch, cfg.source_len, cfg.num_heads, cfg.head_dim)
        c["xattn"] = {name: torch.zeros(xkv, dtype=dtype, device=device)
                      for name in ("xk", "xv")}
    return c
