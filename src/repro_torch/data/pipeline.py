"""Deterministic synthetic data pipeline with per-host sharding (the
port's copy of `repro.data.pipeline`, numpy only: its batches are the
reference's bit for bit).

Every batch is a pure function of (seed, step, host) so that:
  * checkpoint restarts replay the exact token stream (fault tolerance);
  * elastic re-sharding (different host count) keeps global batches
    identical — host h of H draws rows [h*B/H, (h+1)*B/H) of the same
    global batch.

The token distribution is Zipf with a Markov "document" structure (runs of
correlated tokens separated by BOS), which gives a learnable signal for the
example scripts while staying dependency-free.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    doc_len: int = 64


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, num_hosts: int = 1,
                 host_id: int = 0):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.rows = cfg.global_batch // num_hosts

    def _row(self, rng, length):
        c = self.cfg
        v = c.vocab_size
        toks = np.empty(length, dtype=np.int32)
        i = 0
        while i < length:
            base = int(rng.zipf(c.zipf_a) % max(v // 4, 1))
            run = int(rng.integers(4, c.doc_len))
            run = min(run, length - i)
            # simple markov walk around the doc's base token
            steps = rng.integers(-3, 4, run)
            toks[i:i + run] = (base + np.cumsum(steps)) % v
            i += run
        return toks

    def global_batch_at(self, step: int) -> dict:
        """Full global batch (all hosts) — used by single-process runs."""
        c = self.cfg
        out = np.empty((c.global_batch, c.seq_len + 1), dtype=np.int32)
        for r in range(c.global_batch):
            rng = np.random.default_rng(
                np.random.SeedSequence([c.seed, step, r]))
            out[r] = self._row(rng, c.seq_len + 1)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def batch_at(self, step: int) -> dict:
        """This host's rows of the global batch."""
        full = self.global_batch_at(step)
        lo = self.host_id * self.rows
        hi = lo + self.rows
        return {k: v[lo:hi] for k, v in full.items()}
