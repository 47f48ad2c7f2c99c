"""Quotient serving end to end on the PyTorch/CUDA port: generate ->
Build_Bisim -> materialize the quotient artifact -> answer three query
shapes -> absorb an update batch -> re-query at the new epoch (the
`repro_torch` twin of ``examples/quotient_queries.py``).

    PYTHONPATH=src python examples/torch_quotient_queries.py
    PYTHONPATH=src python examples/torch_quotient_queries.py --oocore
    PYTHONPATH=src python examples/torch_quotient_queries.py --device cpu
"""
import argparse
import shutil
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core import BisimMaintainer  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.quotient import (LabelPath, PointLookup,  # noqa: E402
                                  QuotientService, ReachTemplate,
                                  eval_brute)


def sample_path(g, rng, length):
    """Edge-label sequence of a random walk — a path that is guaranteed
    to have at least one witness in the graph."""
    for _ in range(200):
        cur = int(rng.integers(g.num_nodes))
        labs = []
        for _ in range(length):
            out = np.flatnonzero(g.src == cur)
            if out.size == 0:
                labs = None
                break
            e = int(rng.choice(out))
            labs.append(int(g.elabel[e]))
            cur = int(g.dst[e])
        if labs:
            return tuple(labs)
    raise SystemExit("graph has no path of that length")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nodes", type=int, default=2_000)
    ap.add_argument("--edges", type=int, default=8_000)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--oocore", action="store_true",
                    help="maintain through the disk-resident OocBackend")
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    print(f"generating power-law graph ({args.nodes} nodes, "
          f"~{args.edges} edges)")
    g = gen.powerlaw_graph(args.nodes, args.edges, 4, 3, seed=0)

    t0 = time.perf_counter()
    if args.oocore:
        from repro_torch.exmem import OocBackend
        target = OocBackend(g, chunk_edges=1 << 12, device=args.device)
    else:
        target = g
    m = BisimMaintainer(target, args.k, mode="sorted",
                        device=None if args.oocore else args.device)
    workdir = tempfile.mkdtemp(prefix="quotient-example-")
    try:
        svc = QuotientService(m, workdir)
        print(f"build + materialize: {time.perf_counter() - t0:.2f}s; "
              f"blocks per level: {svc.index.counts}")

        # three query shapes: a label path, the same path with endpoint
        # constraints, and a point lookup
        p2 = sample_path(m.graph, rng, 2)
        queries = [
            LabelPath(p2, level=args.k),
            ReachTemplate(p2, src_label=0, tgt_label=1, level=args.k),
            PointLookup(7, args.k),
        ]
        t0 = time.perf_counter()
        answers = svc.query(queries)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"\nepoch {svc.engine.epoch}: 3 queries in {dt:.1f} ms")
        print(f"  LabelPath{p2}: {answers[0].shape[0]} nodes")
        print(f"  ReachTemplate(src=0, tgt=1): {answers[1].shape[0]} nodes")
        print(f"  PointLookup(7): pid={answers[2].pid} "
              f"block_size={answers[2].block_size}")

        # the engine's answers are exact: check one against brute force
        brute = eval_brute(m.graph, queries[0])
        assert np.array_equal(answers[0], brute), "engine != brute force"
        print("  (LabelPath answer verified against brute force)")

        # an update batch: the service patches the touched blocks in
        # place (no rematerialization) and advances the epoch
        n = m.backend.num_nodes
        src = rng.integers(0, n, 16).astype(np.int32)
        dst = rng.integers(0, n, 16).astype(np.int32)
        lab = rng.integers(0, 3, 16).astype(np.int32)
        t0 = time.perf_counter()
        svc.add_edges(src, lab, dst)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"\nabsorbed 16 edge inserts in {dt:.1f} ms "
              f"(patches={svc.patches}, "
              f"rematerializations={svc.rematerializations})")

        answers = svc.query(queries)
        brute = eval_brute(m.graph, queries[0])
        assert np.array_equal(answers[0], brute), "stale after update"
        print(f"epoch {svc.engine.epoch}: LabelPath now "
              f"{answers[0].shape[0]} nodes — reflects the update")
    finally:
        if args.oocore:
            target.close()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
