"""End-to-end training example on the PyTorch/CUDA port: data pipeline ->
train step -> checkpointing -> fault-tolerant restart (the `repro_torch`
twin of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200      # ~20M
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m \\
        --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 50 \\
        --simulate-failure --device cpu

Any decoder-only architecture family can be selected with --arch
(reduced to the preset size); the pipeline gives tokens only, so a vlm
or an encoder-decoder, whose batches need patches or frames, is refused
as the reference's launcher refuses it.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

PRESETS = {
    # name: (d_model, layers, heads, kv, d_ff, vocab)
    "tiny": (128, 4, 4, 2, 384, 2048),     # ~2M params
    "20m": (384, 6, 6, 2, 1024, 8192),     # ~20M
    "100m": (768, 12, 12, 4, 2048, 32768),  # ~110M
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3p8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="runs/train_lm")
    ap.add_argument("--simulate-failure", action="store_true")
    args = ap.parse_args()

    d, layers, h, kv, ff, vocab = PRESETS[args.preset]
    smoke = get_smoke_config(args.arch)
    if smoke.family == "vlm" or smoke.is_encoder_decoder:
        need = "patch embeddings" if smoke.family == "vlm" else "frames"
        raise SystemExit(f"{args.arch}: its batches need {need}, which the "
                         f"token pipeline does not make")
    cfg = smoke.scaled(
        d_model=d, num_layers=layers - layers % len(smoke.layer_pattern),
        num_heads=h, num_kv_heads=kv, d_ff=ff, vocab_size=vocab,
        head_dim=d // h, vocab_pad_multiple=128)
    model = Model(cfg)
    print(f"arch={cfg.name} params={model.num_params() / 1e6:.1f}M")

    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq, seed=0))
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
    trainer = Trainer(
        model, OptConfig(lr=args.lr, warmup_steps=20,
                         total_steps=args.steps), pipe, ckpt=ckpt,
        param_dtype=torch.float32, device=args.device)

    injector = None
    if args.simulate_failure:
        fired = {}

        def injector(step):
            if step == trainer.step + args.steps // 2 and not fired:
                fired["x"] = True
                raise RuntimeError("simulated node failure")

    res = trainer.run(args.steps, ckpt_every=max(args.steps // 5, 10),
                      fault_injector=injector)
    print(f"steps={res.steps_done} restarts={res.restarts} "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"stragglers={len(res.straggler_events)}")
    assert res.losses[-1] < res.losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()
