"""Serving launcher of the port: batched request serving with the
ServeEngine, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \
        --smoke --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b

Flags, defaults and the output line are those of `repro.launch.serve`,
plus ``--device`` and ``--dtype`` (the parameters' and the cache's type;
f32 with ``--smoke`` and bf16 without, as the reference initializes).
Parameters are random, from seed 0.  A vlm (llava-next-34b) prefills
each wave behind its stub patch embeddings (the configuration's
``num_patch_tokens`` a row, normal, from seed 0; ``max_seq`` grows by
that many positions), and an encoder-decoder (seamless-m4t-large-v2)
encodes stub audio frames for each wave (``source_len`` a row, normal,
from seed 0): inputs that the reference's launcher does not supply.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..models.model import Model
from ..serve import ServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="float32 with --smoke, bfloat16 without (default)")
    return ap


def make_engine(args):
    """The model, with random parameters from seed 0, and its engine."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    dtype = DTYPES[args.dtype or ("float32" if args.smoke else "bfloat16")]
    model = Model(cfg).init(0, dtype, resolve_device(args.device))
    # a vlm's cache keeps room for its patch positions
    patches = cfg.num_patch_tokens if cfg.family == "vlm" else 0
    return ServeEngine(model, max_batch=args.max_batch,
                       max_seq=args.max_seq + patches, dtype=dtype)


def make_requests(cfg, n: int):
    """The reference launcher's requests: lengths 4..63 from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, rng.integers(4, 64)).tolist()
            for _ in range(n)]


def patch_embeds(cfg, rows: int, dtype, device, seed: int = 0):
    """Stub patch embeddings of a vlm wave: [rows, num_patch_tokens,
    d_model], normal, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(rows, cfg.num_patch_tokens, cfg.d_model,
                       generator=gen, device=device).to(dtype)


def frames(cfg, rows: int, dtype, device, seed: int = 0):
    """Stub audio frames of an encoder-decoder wave: [rows, source_len,
    d_model], normal, from ``seed``, drawn on the host (the same frames on
    the card and on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(rows, cfg.source_len, cfg.d_model,
                       generator=gen).to(device=device, dtype=dtype)


def wave_inputs(cfg, rows: int, dtype, device):
    """The stub inputs a wave of ``rows`` prefills with, as
    `ServeEngine.serve`'s ``extra``: a vlm's patch embeddings, an
    encoder-decoder's frames; None for a decoder LM."""
    if cfg.family == "vlm":
        return {"patch_embeds": patch_embeds(cfg, rows, dtype, device)}
    if cfg.is_encoder_decoder:
        return {"frames": frames(cfg, rows, dtype, device)}
    return None


def run_serve(args, eng, reqs):
    """Serve ``reqs``; returns (outputs, wall seconds to the last token,
    which the engine has read back to the host).  A vlm's or an
    encoder-decoder's requests are served a wave at a time (the engine's
    waves: by length, up to ``max_batch`` rows), each with its rows' stub
    inputs (`wave_inputs`)."""
    cfg = eng.model.cfg
    t0 = time.perf_counter()
    if not (cfg.family == "vlm" or cfg.is_encoder_decoder):
        outs = eng.serve(reqs, max_new=args.max_new)
        return outs, time.perf_counter() - t0
    outs = [None] * len(reqs)
    by_len = {}
    for i, r in enumerate(reqs):
        by_len.setdefault(len(r), []).append(i)
    for _, idx in sorted(by_len.items()):
        for w in range(0, len(idx), eng.max_batch):
            wave = idx[w:w + eng.max_batch]
            extra = wave_inputs(cfg, len(wave), eng.dtype, eng.model.device)
            for i, g in zip(wave, eng.serve([reqs[i] for i in wave],
                                            max_new=args.max_new,
                                            extra=extra)):
                outs[i] = g
    return outs, time.perf_counter() - t0


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    eng = make_engine(args)
    reqs = make_requests(eng.model.cfg, args.requests)
    outs, dt = run_serve(args, eng, reqs)
    print(f"{len(outs)} requests in {dt:.2f}s, "
          f"{eng.stats.generated_tokens / dt:.1f} tok/s, "
          f"waves={eng.stats.waves}")


if __name__ == "__main__":
    main()
