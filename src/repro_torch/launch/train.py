"""Training launcher of the port, on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_9b \
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_9b \
        --seq 4096 --batch 1 --steps 5

Flags, defaults and output lines are those of `repro.launch.train`, plus
``--device``.  ``--smoke`` trains the reduced config in f32, otherwise
bf16 (f32 AdamW state either way).  Parameters are random, from seed 0.
``--production-mesh`` (16x16) and ``--multi-pod`` (2x16x16) shard the step
over the launched world (torchrun's or Slurm's ranks, one a card:
`launch.cluster.init_cluster`), with ``--shape``'s sharding rules; a
world of another size than the mesh's 256 (512) ranks raises ValueError:

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch gemma2_9b --production-mesh

`make_trainer` and `train` take a `ModelConfig`, so a caller can train a
config of its own (a cut depth) with the launcher's flags.
"""
from __future__ import annotations

import argparse
import math

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import PipelineConfig, TokenPipeline
from ..models.model import Model
from ..optim import OptConfig
from ..train import Trainer
from . import cluster
from . import mesh as meshlib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def make_trainer(cfg, args, params=None, ckpt: bool = True) -> Trainer:
    """The launcher's `Trainer` for ``cfg`` and ``args``, after printing
    the reference's first line.  ``params``: initial parameters (default:
    random from seed 0); ``ckpt=False`` trains without checkpoints."""
    device = resolve_device(args.device)
    mesh = None
    if args.production_mesh or args.multi_pod:
        shape, axes = meshlib.production_shape(multi_pod=args.multi_pod)
        need, world = math.prod(shape), cluster.launched_world()
        if world != need:
            raise ValueError(
                f"--{'multi-pod' if args.multi_pod else 'production-mesh'} "
                f"shards over a {'x'.join(map(str, shape))} mesh of {need} "
                f"ranks (one a card); the launched world has {world}: "
                f"start {need} ranks with torchrun or Slurm")
        cluster.init_cluster(device)
        mesh = meshlib.make_mesh(shape, axes, device_type=device.type)
    model = Model(cfg)
    print(f"{cfg.name}: {model.num_params() / 1e6:.1f}M params, "
          f"{meshlib.world_size()} devices", flush=True)
    pipe = TokenPipeline(
        PipelineConfig(cfg.vocab_size, args.batch, args.seq, seed=0))
    manager = (CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
               if ckpt else None)
    return Trainer(
        model,
        OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                  total_steps=args.steps),
        pipe, ckpt=manager, mesh=mesh,
        rules=meshlib.rules_for_shape(args.shape),
        param_dtype=torch.float32 if args.smoke else torch.bfloat16,
        params=params, device=device)


def train(cfg, args, params=None, ckpt: bool = True):
    """Train ``cfg`` as the launcher does with ``args`` (`make_trainer`,
    then ``--steps`` steps); prints the reference's two lines and returns
    (trainer, TrainResult)."""
    trainer = make_trainer(cfg, args, params, ckpt)
    res = trainer.run(args.steps, ckpt_every=args.ckpt_every)
    print(f"done: steps={res.steps_done} restarts={res.restarts} "
          f"loss={res.losses[0]:.3f}->{res.losses[-1]:.3f}", flush=True)
    return trainer, res


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    train(cfg, args)


if __name__ == "__main__":
    main()
