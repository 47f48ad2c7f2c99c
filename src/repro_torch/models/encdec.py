"""Encoder-decoder backbone of the port (the port of `repro.models.encdec`,
the seamless-m4t family).

The modality frontend is a stub, as in the JAX package: the caller gives
precomputed audio frame embeddings [B, source_len, d_model]; the encoder
is a bidirectional transformer over them (``bidir`` blocks), the decoder
a causal transformer with cross-attention over the encoder's memory
(``xdec`` blocks).  Decode caches both the self-attention k/v (written in
place a step) and the cross-attention ``xk``/``xv`` (static after
prefill).

Both stacks run through the decoder-only LM's loop (`lm._run_groups`,
the port of the JAX package's `lax.scan` over stacked layers), the
decoder's blocks given the encoder's memory; the train kind takes its
two-level remat (`remat_forwards` counts the attention forwards).  The
encoder of a prefill runs its layers' prefill kind (their caches are
dropped), of a train step their train kind, whose attention has a
gradient (`flash_xla.attend_flash`).
"""
from __future__ import annotations

import torch

from . import blocks, layers, lm
from .params import ParamSpec


def encdec_specs(cfg):
    d = cfg.d_model
    enc_pattern = {"0": blocks.block_specs(cfg, "bidir")}
    dec_pattern = {"0": blocks.block_specs(cfg, "xdec")}
    return {"embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                               scale=0.02),
            "enc_groups": lm.stack_specs(enc_pattern, cfg.encoder_layers),
            "enc_norm": layers.norm_spec(d),
            "dec_groups": lm.stack_specs(dec_pattern, cfg.num_layers),
            "final_norm": layers.norm_spec(d),
            "lm_head": layers.linear_spec(d, cfg.padded_vocab, "embed",
                                          "vocab")}


def prefill_launches(cfg) -> int:
    """Attention kernel launches of a prefill: one a layer of the
    encoder, two a decoder layer (its causal self-attention and its
    cross-attention)."""
    return cfg.encoder_layers + 2 * cfg.num_layers


def decode_launches(cfg) -> int:
    """Attention kernel launches of a decode step: the decoder's
    cross-attention, one a layer (the self-attention over the cache is
    plain PyTorch, `layers.attend_decode`)."""
    return cfg.num_layers


def remat_forwards(cfg) -> int:
    """Attention forwards of one train step: each stack through
    `lm._run_train`'s two-level remat (`lm.stack_remat_forwards`), one
    forward an encoder layer and two a decoder layer; the backward runs
    once each of `prefill_launches`' calls."""
    return (lm.stack_remat_forwards(cfg.encoder_layers, 1)
            + lm.stack_remat_forwards(cfg.num_layers, 2))


def encode(params, cfg, frames, *, kind="prefill"):
    """frames: [B, Sm, D] stub embeddings -> encoder memory [B, Sm, D].
    ``kind`` "train" runs under `lm._run_train`'s remat, with gradients;
    a prefill drops the layers' caches."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x, _ = lm._run_groups(params, cfg, frames, kind=kind,
                          positions=positions, stack="enc_groups",
                          pattern=("bidir",), keep_cache=False)
    return layers.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encdec_forward(params, cfg, frames, tokens, *, kind="prefill",
                   return_hidden: bool = False):
    """Train/prefill: encode ``frames`` [B, Sm, D], decode ``tokens``
    [B, S].  Returns (logits [B, S, V], cache), or (final-normed hidden,
    cache) with ``return_hidden``."""
    frames = frames.to(params["embed"].dtype)
    memory = encode(params, cfg, frames, kind=kind)
    x = lm._embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = lm._run_groups(params, cfg, x, kind=kind, positions=positions,
                              stack="dec_groups", memory=memory)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, cache
    return layers.linear(params["lm_head"], x), cache


def encdec_decode_step(params, cfg, cache, token, index: int):
    """One decode step (token [B], index the position, an int); the
    cross-attention's k and v come from the cache."""
    x = lm._embed(params, cfg, token[:, None])
    positions = torch.full((x.shape[0], 1), index, device=x.device)
    x, cache = lm._run_groups(params, cfg, x, kind="decode",
                              positions=positions, cache=cache, index=index,
                              stack="dec_groups")
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return layers.linear(params["lm_head"], x)[:, 0], cache


# the decode cache and its axes: the decoder-only LM's over the decoder's
# ("xdec",) pattern, whose blocks also hold the cross-attention's xk/xv
encdec_init_cache = lm.init_cache
encdec_cache_axes = lm.cache_axes
