"""Top-level model of the port: config -> specs, parameters, the train
loss, prefill and decode, and the dry-run's input specs (meta tensors +
logical axes) (the port of `repro.models.model.Model`: the decoder LMs,
dense, MoE, SSM and hybrid, a vlm's stub patch embeddings included, and
the encoder-decoder over stub audio frames)."""
from __future__ import annotations

import functools

import torch
from torch import nn

from .. import resolve_device
from . import encdec, layers, lm, params as P
from .config import ModelConfig, ShapeConfig


def _register(module: nn.Module, tree: dict, trainable: bool) -> dict:
    """Register ``tree``'s tensors as parameters of nested submodules of
    ``module`` (frozen unless ``trainable``); returns the same tree of
    parameters."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            sub = nn.Module()
            module.add_module(key, sub)
            out[key] = _register(sub, val, trainable)
        else:
            out[key] = nn.Parameter(val, requires_grad=trainable)
            module.register_parameter(key, out[key])
    return out


class Model(nn.Module):
    """An LM (decoder-only or encoder-decoder) holding its parameter
    tree (``self.params``: nested dicts with the JAX package's keys,
    registered as parameters).

    ``init`` or ``load`` gives it parameters, frozen for serving or
    trainable (``trainable=True``) for `loss_fn`'s gradients; `prefill`,
    `decode_step` and `loss_fn` run on the parameters' device.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.params = None

    def param_specs(self):
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_specs(self.cfg)
        return lm.lm_specs(self.cfg)

    def param_shapes(self, dtype=torch.bfloat16):
        return P.param_shapes(self.param_specs(), dtype)

    def param_axes(self):
        return P.param_axes(self.param_specs())

    def num_params(self) -> int:
        return P.count_params(self.param_specs())

    def init(self, seed: int = 0, dtype=torch.float32, device=None,
             trainable: bool = False, place=None):
        """Random parameters from ``seed`` on ``device`` (the card unless
        ``cpu`` is asked); ``place`` as `params.init_params` takes it."""
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return self.load(P.init_params(self.param_specs(), gen, dtype,
                                       place), trainable)

    def load(self, params, trainable: bool = False):
        """Take a parameter tree (for example `params_from_jax`'s), after
        checking it against the specs."""
        want = P.tree_map(lambda s: tuple(s.shape), self.param_specs())
        if P.tree_map(lambda t: tuple(t.shape), params) != want:
            raise ValueError(f"parameter tree does not fit {self.cfg.name}")
        self.params = _register(self, params, trainable)
        return self

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def loss_fn(self, params, batch):
        """Train loss through the chunked cross-entropy ([B, S, V] logits
        never materialize; each chunk's logits are recomputed in the
        backward).  batch: {"tokens", "labels"}, [B, S] integer tensors on
        the parameters' device; a vlm's also "patch_embeds" [B, P,
        d_model], ahead of P fewer tokens; an encoder-decoder's also
        "frames" [B, Sm, d_model], and its head is ``lm_head`` alone."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            hidden, _ = encdec.encdec_forward(
                params, cfg, batch["frames"], batch["tokens"], kind="train",
                return_hidden=True)
            head = functools.partial(layers.linear, params["lm_head"])
        else:
            hidden, _ = lm.lm_forward(params, cfg, batch["tokens"],
                                      kind="train",
                                      patch_embeds=self._patches(batch),
                                      return_hidden=True)
            head = lambda xc: lm._logits(params, cfg, xc)  # noqa: E731
        return lm.chunked_ce(head, hidden, batch["labels"], cfg.vocab_size)

    def _patches(self, batch):
        """A vlm batch's patch embeddings (the reference reads them for
        every vlm batch); None for any other family."""
        return batch["patch_embeds"] if self.cfg.family == "vlm" else None

    def prefill(self, tokens, patch_embeds=None, frames=None):
        """tokens: [B, S] integer; ``patch_embeds`` [B, P, d_model] (a
        vlm's) go first; ``frames`` [B, Sm, d_model] are an
        encoder-decoder's encoder input.  Returns (logits [B, P + S, V],
        cache)."""
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_forward(self.params, self.cfg, frames,
                                         tokens)
        return lm.lm_forward(self.params, self.cfg, tokens,
                             patch_embeds=patch_embeds)

    def decode_step(self, cache, token, index: int):
        if self.cfg.is_encoder_decoder:
            return encdec.encdec_decode_step(self.params, self.cfg, cache,
                                             token, index)
        return lm.lm_decode_step(self.params, self.cfg, cache, token, index)

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16):
        return lm.init_cache(self.cfg, batch, seq, dtype, self.device)

    def pad_cache(self, cache, batch: int, max_seq: int, dtype=torch.bfloat16):
        """Right-pad a prefill cache (prompt length) to decode capacity.
        Every leaf is copied into `init_cache`'s template, in its dtype:
        the sequence-free SSM leaves (``h``, ``conv``) have the template's
        shape, so they are only cast (``h`` stays f32)."""
        def pad(leaf, tmpl):
            tmpl[tuple(slice(0, n) for n in leaf.shape)] = leaf
            return tmpl
        return P.tree_map(pad, cache, self.init_cache(batch, max_seq, dtype))

    def cache_axes(self):
        return lm.cache_axes(self.cfg)

    def cache_shapes(self, batch: int, seq: int, dtype=torch.bfloat16):
        """Meta tensors of `init_cache`'s tree (no storage)."""
        return lm.cache_shapes(self.cfg, batch, seq, dtype)

    # ------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig, dtype=torch.bfloat16):
        """Meta-tensor stand-ins + logical axes for every model input.

        train:  {tokens, labels[, patch_embeds | frames]}
        prefill:{tokens[, patch_embeds | frames]}
        decode: {token, index, cache}

        A vlm's batch holds P = ``num_patch_tokens`` patch embeddings
        [b, P, d_model] and s - P text tokens; an encoder-decoder's
        ``source_len`` frames [b, Sm, d_model] ahead of s tokens; an SSM's
        decode cache holds its ``h`` and ``conv`` leaves, an
        encoder-decoder's the cross-attention's ``xk``/``xv``.
        """
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        tok_ax = ("act_batch", "act_seq")
        meta = lambda *size, dt=i32: torch.empty(  # noqa: E731
            size, dtype=dt, device="meta")
        specs, axes = {}, {}
        if shape.kind in ("train", "prefill"):
            text = s
            if cfg.family == "vlm":
                p = cfg.num_patch_tokens
                text = s - p
                specs["patch_embeds"] = meta(b, p, cfg.d_model, dt=dtype)
                axes["patch_embeds"] = ("act_batch", "act_seq", "act_embed")
            elif cfg.is_encoder_decoder:
                specs["frames"] = meta(b, cfg.source_len, cfg.d_model,
                                       dt=dtype)
                axes["frames"] = ("act_batch", "act_frames", "act_embed")
            specs["tokens"], axes["tokens"] = meta(b, text), tok_ax
            if shape.kind == "train":
                specs["labels"], axes["labels"] = meta(b, s), tok_ax
        else:  # decode
            specs["token"], axes["token"] = meta(b), ("act_batch",)
            specs["index"], axes["index"] = meta(), ()
            specs["cache"] = self.cache_shapes(b, s, dtype)
            axes["cache"] = self.cache_axes()
        return specs, axes


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D train (3 fwd+bwd passes worth of 2·N·D), 2·N·D
    decode/prefill; N = the active parameters (an MoE counts top_k routed
    experts and the shared ones: the inactive routed experts' 3·d·d_ff a
    layer are subtracted)."""
    n_active = P.count_params(encdec.encdec_specs(cfg)
                              if cfg.is_encoder_decoder else lm.lm_specs(cfg))
    if cfg.num_experts:
        moe_layers = sum(k == "moe" for k in cfg.layer_pattern) \
            * cfg.pattern_groups
        n_active -= ((cfg.num_experts - cfg.moe_top_k) * 3 * cfg.d_model
                     * cfg.d_ff * moe_layers)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token per row
