"""End-to-end graph pipeline on the PyTorch/CUDA port: generate ->
(distributed) Build_Bisim -> incremental maintenance -> validate ->
persist (the `repro_torch` twin of ``examples/bisim_pipeline.py``).

    PYTHONPATH=src python examples/torch_bisim_pipeline.py
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 examples/torch_bisim_pipeline.py --distributed \\
        --dist-backend gloo

``--distributed`` builds over a `torch.distributed` group: torchrun's
ranks, or one rank in this process without its variables.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import (BisimMaintainer, build_bisim,  # noqa: E402
                              build_bisim_distributed, same_partition)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.launch.cluster import init_cluster  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--edges", type=int, default=400_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--ranking", default="bucketed")
    ap.add_argument("--dist-backend", default=None,
                    help="nccl or gloo (default: the device's)")
    ap.add_argument("--out", default="runs/partition.npz")
    args = ap.parse_args()
    dev = args.device

    print(f"generating power-law graph ({args.nodes} nodes, "
          f"~{args.edges} edges)")
    g = gen.powerlaw_graph(args.nodes, args.edges, 4, 3, seed=0)

    rank = 0
    if args.distributed:
        rank, world = init_cluster(dev, args.dist_backend)
        if rank == 0:
            print(f"distributed Build_Bisim over {world} ranks "
                  f"(ranking={args.ranking})")
        t0 = time.perf_counter()
        try:
            res = build_bisim_distributed(g, args.k, mode="sorted",
                                          ranking=args.ranking, device=dev)
        finally:
            dist.destroy_process_group()
        if rank:
            return
    else:
        t0 = time.perf_counter()
        res = build_bisim(g, args.k, mode="sorted", device=dev)
    dt = time.perf_counter() - t0
    print(f"partitions per iteration: {res.counts} ({dt:.2f}s)")

    # incremental maintenance on top
    m = BisimMaintainer(g, min(args.k, 5), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(5):
        s, t = rng.integers(0, g.num_nodes, 2)
        m.add_edge(int(s), 0, int(t))
    print(f"5 incremental edge inserts: {time.perf_counter() - t0:.2f}s")
    ref = build_bisim(m.graph, min(args.k, 5), early_stop=False, device=dev)
    assert same_partition(m.pid(), ref.pids[-1])
    print("maintenance == rebuild: OK")

    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(args.out, pids=res.pids[-1])
    print(f"final partition saved to {args.out}")


if __name__ == "__main__":
    main()
