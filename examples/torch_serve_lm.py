"""End-to-end serving example on the PyTorch/CUDA port: batched requests
through the ServeEngine (wave-based batching, KV-cache decode, greedy
sampling) (the `repro_torch` twin of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 24 \\
        --max-new 32
    PYTHONPATH=src python examples/torch_serve_lm.py \\
        --arch seamless_m4t_large_v2 --device cpu

A vlm's or an encoder-decoder's waves prefill over stub inputs (patch
embeddings, audio frames) from seed 0, as the serving launcher gives
them (`launch.serve.wave_inputs`).
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_9b",
                    help="any assigned arch (reduced config)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch).scaled(
        d_model=256, num_heads=8, num_kv_heads=4, head_dim=32, d_ff=768,
        vocab_size=4096, vocab_pad_multiple=128)
    model = Model(cfg).init(0, torch.float32, args.device)
    print(f"serving {cfg.name}-reduced: {model.num_params() / 1e6:.1f}M "
          f"params, max_batch={args.max_batch}")

    rng = np.random.default_rng(0)
    requests = [rng.integers(1, cfg.vocab_size,
                             rng.integers(4, 48)).tolist()
                for _ in range(args.requests)]

    eng = ServeEngine(model, max_batch=args.max_batch,
                      max_seq=128 + cfg.num_patch_tokens)
    outs, dt = launcher.run_serve(args, eng, requests)
    print(f"served {len(outs)} requests in {dt:.2f}s "
          f"({eng.stats.generated_tokens / dt:.1f} tok/s); "
          f"waves={eng.stats.waves} decode_steps={eng.stats.decode_steps}")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: prompt_len={len(requests[i])} -> {o[:12]}...")


if __name__ == "__main__":
    main()
