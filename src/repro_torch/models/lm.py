"""Decoder-only LM of the port (the port of `repro.models.lm`, prefill and
decode).  The JAX package's `lax.scan` over pattern groups becomes a
Python loop over the [G, ...] slices of the stacked parameters; training
(remat, chunked cross-entropy) waits for its slice."""
from __future__ import annotations

import torch

from .. import resolve_device
from . import blocks, layers
from .params import ParamSpec, tree_map


def stack_specs(specs, groups: int):
    """Prepend the stacked 'layers' dim to every ParamSpec in the tree."""
    return tree_map(lambda s: ParamSpec((groups,) + s.shape, init=s.init,
                                        scale=s.scale), specs)


def lm_specs(cfg):
    d = cfg.d_model
    pattern = {str(i): blocks.block_specs(cfg, k)
               for i, k in enumerate(cfg.layer_pattern)}
    specs = {"embed": ParamSpec((cfg.padded_vocab, d), scale=0.02),
             "groups": stack_specs(pattern, cfg.pattern_groups),
             "final_norm": layers.norm_spec(d)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = layers.linear_spec(d, cfg.padded_vocab)
    return specs


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = layers.linear(params["lm_head"], x)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _embed(params, cfg, tokens):
    return params["embed"][tokens]


def _run_groups(params, cfg, x, *, kind, positions, cache=None, index=None):
    """Every layer in order.  Prefill returns the new cache stacked
    [G, ...]; decode updates ``cache`` in place and returns it."""
    new = []
    for g in range(cfg.pattern_groups):
        gp = tree_map(lambda a: a[g], params["groups"])
        gc = None if cache is None else tree_map(lambda a: a[g], cache)
        ncs = {}
        for i, k in enumerate(cfg.layer_pattern):
            x, ncs[str(i)] = blocks.apply_block(
                gp[str(i)], x, cfg, k, kind=kind, positions=positions,
                cache=None if gc is None else gc[str(i)], index=index)
        new.append(ncs)
    if cache is not None:
        return x, cache
    return x, tree_map(lambda *leaves: torch.stack(leaves), *new)


def lm_forward(params, cfg, tokens):
    """Full-sequence prefill forward. Returns (logits, cache)."""
    x = _embed(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, cache = _run_groups(params, cfg, x, kind="prefill",
                           positions=positions)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x), cache


def lm_decode_step(params, cfg, cache, token, index: int):
    """One decode step. token: [B] integer; index: the position, an int."""
    x = _embed(params, cfg, token[:, None])
    positions = torch.full((x.shape[0], 1), index, device=x.device)
    x, cache = _run_groups(params, cfg, x, kind="decode",
                           positions=positions, cache=cache, index=index)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache


def init_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed decode cache, stacked over pattern groups ([G, ...] leaves),
    on the card unless ``device="cpu"`` is asked (`resolve_device`)."""
    device = resolve_device(device)
    g = cfg.pattern_groups
    return {str(i): tree_map(lambda a: a.new_zeros((g,) + a.shape),
                             blocks.cache_struct(cfg, k, batch, seq, dtype,
                                                 device))
            for i, k in enumerate(cfg.layer_pattern)}
