"""Decoder-only LM of the port (the port of `repro.models.lm`: train,
prefill and decode; dense, MoE, vlm, SSM and hybrid families).  The JAX
package's `lax.scan` over pattern groups becomes a Python loop over the
[G, ...] slices of the stacked parameters; its `jax.checkpoint` remat
becomes `torch.utils.checkpoint` over the same segments, and its chunked
cross-entropy recomputes each chunk's logits in the backward the same
way."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..launch import mesh as meshlib
from . import blocks, layers
from .params import ParamSpec, tree_leaves, tree_map

shard = meshlib.shard


def stack_specs(specs, groups: int):
    """Prepend the stacked 'layers' dim to every ParamSpec in the tree."""
    return tree_map(lambda s: ParamSpec((groups,) + s.shape,
                                        ("layers",) + s.axes, init=s.init,
                                        scale=s.scale), specs)


def lm_specs(cfg):
    d = cfg.d_model
    pattern = {str(i): blocks.block_specs(cfg, k)
               for i, k in enumerate(cfg.layer_pattern)}
    specs = {"embed": ParamSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                                scale=0.02),
             "groups": stack_specs(pattern, cfg.pattern_groups),
             "final_norm": layers.norm_spec(d)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = layers.linear_spec(d, cfg.padded_vocab, "embed",
                                              "vocab")
    if "ssm_attn" in cfg.layer_pattern:
        specs["shared"] = blocks.shared_block_specs(cfg)
    return specs


def _sqrt_split(g: int):
    """Factor g = go * gi minimizing go + gi (sqrt activation remat)."""
    best = (g, 1)
    for d in range(2, int(g ** 0.5) + 1):
        if g % d == 0 and (g // d + d) < sum(best):
            best = (g // d, d)
    return best


def attention_layers(cfg) -> int:
    """The layers that run an attention forward (`blocks.has_attention`):
    every layer of a dense or MoE model, zamba2's ssm_attn layers, none of
    mamba2's.  A prefill launches the forward kernel once each, and a
    train step's backward once each."""
    return cfg.pattern_groups * sum(map(blocks.has_attention,
                                        cfg.layer_pattern))


def remat_forwards(cfg) -> int:
    """The attention forwards of one train step, summed over the
    attention layers (the backward runs once each)."""
    return stack_remat_forwards(cfg.pattern_groups,
                                attention_layers(cfg) // cfg.pattern_groups)


def stack_remat_forwards(groups: int, per_group: int) -> int:
    """The attention forwards of one train step through `_run_train` over
    a stack of ``groups`` groups of ``per_group`` attention forwards each.
    A layer's forward runs once, once more when its group is recomputed in
    the backward, and once more when its outer segment is (two-level
    remat, gi > 1) — except in the last group of a segment, whose output
    no saved tensor needs: non-reentrant checkpoint's early stop ends the
    segment's recompute before it."""
    go, gi = _sqrt_split(groups)
    if gi == 1:
        return 2 * groups * per_group
    return go * per_group * (3 * (gi - 1) + 2)


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ meshlib.gather_weight(params["embed"]).to(x.dtype).T
    else:
        logits = layers.linear(params["lm_head"], x)
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shard(logits, "act_batch", "act_seq", "act_vocab")


def _embed(params, cfg, tokens):
    table = params["embed"]
    if meshlib.is_dtensor(table):
        # embedding's vocab-parallel rule: each rank looks up the rows it
        # holds and the partial sums meet in `shard`'s reduce-scatter
        x = F.embedding(tokens, meshlib.gather_weight(table))
    else:
        x = table[tokens]
    return shard(x, "act_batch", "act_seq", "act_embed")


def _run_groups(params, cfg, x, *, kind, positions, cache=None, index=None,
                stack="groups", pattern=None, memory=None,
                keep_cache: bool = True):
    """Every layer of ``params[stack]`` in order: its [G, ...] groups, each
    of ``pattern``'s blocks (default ``cfg.layer_pattern``); ``memory``,
    the encoder's output, reaches each block (an xdec block's
    cross-attention).  Prefill returns the new cache stacked [G, ...]
    (None without ``keep_cache``: the encoder's, never read); decode
    updates ``cache`` in place and returns it; train returns no cache and
    recomputes in the backward (`_run_train`)."""
    pattern = pattern or cfg.layer_pattern
    if kind == "train":
        return _run_train(params, cfg, x, positions, stack, pattern,
                          memory), None
    shared = params.get("shared")
    stacked = params[stack]
    new = []
    for g in range(_groups(stacked)):
        gp = tree_map(lambda a: a[g], stacked)
        gc = None if cache is None else tree_map(lambda a: a[g], cache)
        ncs = {}
        for i, k in enumerate(pattern):
            x, ncs[str(i)] = blocks.apply_block(
                gp[str(i)], x, cfg, k, kind=kind, positions=positions,
                cache=None if gc is None else gc[str(i)], index=index,
                shared=shared, memory=memory)
        x = shard(x, "act_batch", "act_seq", "act_embed")
        if keep_cache:
            new.append(ncs)
    if cache is not None or not keep_cache:
        return x, cache
    return x, tree_map(lambda *leaves: torch.stack(leaves), *new)


def _groups(stacked) -> int:
    """The number of groups of a stacked parameter tree (its leaves'
    leading dim)."""
    return tree_leaves(stacked)[0].shape[0]


def _run_train(params, cfg, x, positions, stack, pattern, memory):
    """The train kind's two-level sqrt remat: each group runs under its
    own checkpoint (only its input is kept), and each outer segment of gi
    groups under another, so the forward keeps go + gi residual slices,
    not G.  The stacked [G, ...] parameters are unbound once, so each
    leaf gets one stacked gradient rather than a full-size one a group.
    The shared block's parameters (zamba2) and the encoder's ``memory``
    reach every group's checkpoint through the closure, so their
    gradients sum over all their uses."""
    g = _groups(params[stack])
    shared = params.get("shared")
    per_leaf = tree_map(lambda a: a.unbind(0), params[stack])
    groups = [tree_map(lambda t, i=i: t[i], per_leaf) for i in range(g)]

    def body(xc, gp):
        for i, k in enumerate(pattern):
            xc, _ = blocks.apply_block(gp[str(i)], xc, cfg, k, kind="train",
                                       positions=positions, shared=shared,
                                       memory=memory)
        return shard(xc, "act_batch", "act_seq", "act_embed")

    def inner(xc, gp):
        return checkpoint(body, xc, gp, use_reentrant=False)

    def outer(xc, segment):
        for gp in segment:
            xc = inner(xc, gp)
        return xc

    go, gi = _sqrt_split(g)
    if gi == 1:
        return outer(x, groups)
    for o in range(go):
        x = checkpoint(outer, x, groups[o * gi:(o + 1) * gi],
                       use_reentrant=False)
    return x


def lm_forward(params, cfg, tokens, *, kind="prefill", patch_embeds=None,
               return_hidden: bool = False):
    """Full-sequence forward (train or prefill). Returns (logits, cache),
    or (final-normed hidden, cache) with ``return_hidden`` (the chunked
    cross-entropy's input).  ``patch_embeds`` ([B, P, d_model], a vlm's
    stub image embeddings) are prepended to the token embeddings, so
    positions count them first."""
    x = _embed(params, cfg, tokens)
    if patch_embeds is not None:  # vlm: prepend stub patch embeddings
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    # one row of positions, broadcast over the batch by rope
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = _run_groups(params, cfg, x, kind=kind, positions=positions)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, cache
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


def cache_shapes(cfg, batch: int, seq: int, dtype=torch.bfloat16):
    """Meta tensors of `init_cache`'s tree (no storage)."""
    g = cfg.pattern_groups
    return {str(i): tree_map(lambda a: a.new_empty((g,) + a.shape),
                             blocks.cache_struct(cfg, k, batch, seq, dtype,
                                                 "meta"))
            for i, k in enumerate(cfg.layer_pattern)}


def cache_axes(cfg):
    """Logical axes tree matching `init_cache`'s structure."""
    kv = ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None)

    def axes_for(kind):
        blocks._check_kind(cfg, kind)
        if kind in blocks.SSM_KINDS:
            c = {"ssm": {"h": ("layers", "act_batch", "act_heads", None,
                               None),
                         "conv": ("layers", "act_batch", None, "act_mlp")}}
            if kind == "ssm_attn":
                c["shared_attn"] = {"k": kv, "v": kv}
            return c
        if cfg.attention == "mla":
            latent = ("layers", "act_batch", "act_kv_seq", None)
            return {"attn": {"c_kv": latent, "k_rope": latent}}
        if kind == "xdec":  # the cross-attention's k/v over the frames
            xkv = ("layers", "act_batch", "act_frames", "act_heads", None)
            return {"attn": {"k": kv, "v": kv},
                    "xattn": {"xk": xkv, "xv": xkv}}
        return {"attn": {"k": kv, "v": kv}}
    return {str(i): axes_for(k) for i, k in enumerate(cfg.layer_pattern)}


def _nll_sum(logits, labels, vocab_size: int):
    """(sum of logz - gold over labels >= 0, their count), padded-vocab
    columns masked out, in f32 (f64 for f64 logits)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    v = logits.shape[-1]
    if v > vocab_size:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = logits + torch.where(pad, -1e9, 0.0).to(logits.dtype)
    if meshlib.is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
        nll = logz - gold
    valid = (labels >= 0).to(logits.dtype)
    return torch.sum(nll * valid), torch.sum(valid)


class _VocabParallelNLL(torch.autograd.Function):
    """logz - gold of each row of vocab-split logits, on the rank's shard
    (Megatron's vocab-parallel cross-entropy): the row max and the sums of
    exponentials and gold logits are all-reduced over the ``groups`` that
    split the vocab, the gold logit taken where the rank holds it; the
    backward is softmax minus one-hot, on the shard."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, groups):
        import torch.distributed as dist
        m = logits.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(logits - m[..., None])
        local = labels.long() - v0
        inside = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        gold = torch.gather(logits, -1, local[..., None])[..., 0]
        sums = torch.stack([e.sum(dim=-1), torch.where(inside, gold, 0.0)])
        for g in groups:
            dist.all_reduce(sums, group=g)
        ctx.save_for_backward(e, sums[0], local, inside)
        return m + torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, grad):
        e, total, local, inside = ctx.saved_tensors
        d = e / total[..., None]
        d.scatter_add_(-1, local[..., None],
                       -inside.to(d.dtype)[..., None])
        return d * grad[..., None], None, None, None


def _vocab_parallel_nll(logits, labels):
    """`_VocabParallelNLL` of DTensor logits [..., V] (split over V by some
    mesh dims) and labels, as a DTensor with the logits' other
    placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    vdim = logits.ndim - 1
    groups = [mesh.get_group(i) for i, p in enumerate(pl)
              if p == Shard(vdim)]
    want = [Replicate() if p == Shard(vdim) else p for p in pl]
    if not meshlib.is_dtensor(labels):
        labels = meshlib.distribute(labels, mesh, want)
    elif list(labels.placements) != want:
        labels = labels.redistribute(mesh, want)
    v0 = meshlib.local_offset(vdim, logits.shape[-1], mesh, pl)
    out = _VocabParallelNLL.apply(logits.to_local(grad_placements=pl),
                                  labels.to_local(), v0, groups)
    return DTensor.from_local(out, mesh, want)


def chunked_ce(head_fn, x, labels, vocab_size: int, *, chunk: int = 512):
    """Fused cross-entropy over sequence chunks.

    Never materializes [B, S, V] logits: each chunk's logits are computed,
    reduced and (under a checkpoint) recomputed in the backward. x is the
    final-normed hidden state [B, S, D]; head_fn maps [B, c, D] -> logits.
    """
    s = x.shape[1]
    if s % chunk:
        chunk = s
    tot = cnt = 0.0
    def nll(xc, lc):
        return _nll_sum(head_fn(xc), lc, vocab_size)
    for c0 in range(0, s, chunk):
        t, c = checkpoint(nll, x[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(logits, labels, vocab_size: int):
    """Mean CE over labels >= 0 (padded-vocab columns masked out)."""
    tot, cnt = _nll_sum(logits, labels, vocab_size)
    return tot / torch.clamp(cnt, min=1.0)
