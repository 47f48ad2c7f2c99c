"""Batched serving engine of the port: prefill + greedy decode, wave-style
batching over a request queue (the port of `repro.serve.engine`).

Each wave is one prefill of its left-padded prompts (every layer's
attention through the Hopper flash attention kernel on the card) and then
one decode step a token, writing the cache in place (an encoder-decoder's
cross-attention reads its static cache through the kernel at each
step).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.model import Model


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_steps: int = 0
    generated_tokens: int = 0
    waves: int = 0


class ServeEngine:
    def __init__(self, model: Model, *, max_batch: int = 8,
                 max_seq: int = 256, dtype=torch.float32,
                 eos_id: Optional[int] = None):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.eos_id = eos_id
        self.stats = ServeStats()

    def _generate_wave(self, prompts: List[List[int]], max_new: int,
                       extra: Optional[dict] = None):
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), dtype=np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left-pad (right-aligned prompts)
        vocab = self.model.cfg.padded_vocab
        if toks.size and not (0 <= toks.min() and toks.max() < vocab):
            raise ValueError(f"prompt tokens must lie in [0, {vocab})")
        model = self.model
        logits, cache = model.prefill(torch.from_numpy(toks).to(model.device),
                                      **(extra or {}))
        self.stats.prefill_tokens += b * plen
        # the prefill's positions (a vlm's patches and the prompt) and the
        # new tokens: the reference counts only the prompt here, so its
        # cache is short of the patches and a vlm wave fails to pad
        offset = logits.shape[1] - 1  # position of last prompt token
        cache = model.pad_cache(cache, b,
                                min(offset + 1 + max_new, self.max_seq),
                                self.dtype)
        tok = torch.argmax(logits[:, -1], dim=-1)
        outs = [tok.cpu().numpy()]
        done = np.zeros(b, dtype=bool)
        for t in range(1, max_new):
            logits_t, cache = model.decode_step(cache, tok, offset + t)
            tok = torch.argmax(logits_t, dim=-1)
            self.stats.decode_steps += 1
            step_tok = tok.cpu().numpy()
            if self.eos_id is not None:
                done |= step_tok == self.eos_id
            outs.append(step_tok)
            if done.all():
                break
        gen = np.stack(outs, axis=1)  # [b, <=max_new]
        self.stats.generated_tokens += int(gen.size)
        self.stats.waves += 1
        return [g.tolist() for g in gen]

    def serve(self, requests: List[List[int]], max_new: int = 32,
              extra: Optional[dict] = None) -> List[List[int]]:
        """Wave-based batching over a request queue.

        Waves are bucketed by prompt length so no row needs padding —
        results are independent of batch composition (pad tokens would
        otherwise be attended; production engines mask, we bucket).
        ``extra`` (a vlm's ``{"patch_embeds": [B, P, d_model]}``, an
        encoder-decoder's ``{"frames": [B, source_len, d_model]}``) goes
        to every wave's prefill unchanged, as the reference passes it: its
        batch dim must be the wave's."""
        results: List[Optional[List[int]]] = [None] * len(requests)
        by_len: dict = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r), []).append((i, r))
        for _, queue in sorted(by_len.items()):
            while queue:
                wave = queue[: self.max_batch]
                queue = queue[self.max_batch:]
                gens = self._generate_wave([r for _, r in wave], max_new,
                                           extra)
                for (i, _), g in zip(wave, gens):
                    results[i] = g
        return results  # type: ignore
