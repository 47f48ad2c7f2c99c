"""Per-layer blocks of the port (the port of `repro.models.blocks`, for
the block kinds of the ported architectures: dense/local/global, and moe,
each with GQA or MLA attention; an moe block's MLP is `models.moe`)."""
from __future__ import annotations

import torch

from . import layers, moe

ATTN_KINDS = ("dense", "local", "global", "moe")
ATTENTIONS = ("gqa", "mla")


def _check_kind(cfg, kind):
    if kind not in ATTN_KINDS or cfg.attention not in ATTENTIONS:
        raise NotImplementedError(
            f"block kind {kind!r} with {cfg.attention} attention is not "
            f"ported yet (ROADMAP.md, queue 1 item 8: the other "
            f"architectures); ported: {ATTN_KINDS} with {ATTENTIONS}")


def block_specs(cfg, kind):
    _check_kind(cfg, kind)
    d = cfg.d_model
    attn = layers.mla_specs(cfg) if cfg.attention == "mla" \
        else layers.gqa_specs(cfg)
    if kind == "moe":
        return {"ln_attn": layers.norm_spec(d), "attn": attn,
                "ln_mlp": layers.norm_spec(d), "moe": moe.moe_specs(cfg)}
    return {"ln_attn": layers.norm_spec(d), "attn": attn,
            "ln_mlp": layers.norm_spec(d), "mlp": layers.mlp_specs(cfg)}


def apply_block(p, x, cfg, block_kind, *, kind, positions, cache=None,
                index=None):
    """Returns (x, new_cache_for_this_block)."""
    _check_kind(cfg, block_kind)
    h = layers.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    c = None if cache is None else cache["attn"]
    if cfg.attention == "mla":
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
    h = layers.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if block_kind == "moe":
        x = x + moe.apply_moe(p["moe"], h, cfg)
    else:
        x = x + layers.apply_mlp(p["mlp"], h)
    return x, {"attn": c}


def cache_struct(cfg, block_kind, batch: int, seq: int, dtype, device):
    """Zero-initialized cache tree for one block: k and v of every kv head
    (GQA), or MLA's compressed latent and shared rope key."""
    _check_kind(cfg, block_kind)
    if cfg.attention == "mla":
        shapes = {"c_kv": (batch, seq, cfg.kv_lora_rank),
                  "k_rope": (batch, seq, cfg.rope_head_dim)}
    else:
        kv = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
        shapes = {"k": kv, "v": kv}
    return {"attn": {name: torch.zeros(shape, dtype=dtype, device=device)
                     for name, shape in shapes.items()}}
