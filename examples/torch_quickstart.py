"""Quickstart on the PyTorch/CUDA port: k-bisimulation partitioning in 30
lines (the `repro_torch` twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py            # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core import (BisimMaintainer, build_bisim,  # noqa: E402
                              oracle_pids, same_partition)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.storage import paper_example_graph  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--edges", type=int, default=200_000)
    args = ap.parse_args()
    dev = args.device

    # 1. the paper's Figure-1 social network
    g = paper_example_graph()
    res = build_bisim(g, k=2, early_stop=False, device=dev)
    print("paper example block counts per iteration:", res.counts)
    print("pId_2 per node:", res.pids[2].tolist())

    # 2. a bigger random graph, all three signature modes
    g = gen.powerlaw_graph(args.nodes, args.edges, num_node_labels=4, seed=0)
    for mode in ("sorted", "dedup_hash", "multiset"):
        res = build_bisim(g, k=10, mode=mode, device=dev)
        print(f"mode={mode:10s} partitions={res.counts[-1]:6d} "
              f"converged_at={res.converged_at} "
              f"time={sum(s.seconds for s in res.stats):.2f}s")

    # 3. incremental maintenance (Algorithm 4) vs rebuild
    g = gen.random_graph(2_000, 6_000, 3, 2, seed=1)
    m = BisimMaintainer(g, k=5, device=dev)
    rep = m.add_edge(10, 0, 20)
    print("add_edge nodes checked per level:", rep.nodes_checked)
    assert same_partition(m.pid(), build_bisim(m.graph, 5, early_stop=False,
                                               device=dev).pids[5])
    print("maintenance == rebuild: OK")

    # 4. exact-oracle validation on a small graph
    g = gen.random_graph(100, 300, 3, 2, seed=2)
    res = build_bisim(g, 4, early_stop=False, device=dev)
    ora = oracle_pids(g, 4, early_stop=False)
    assert all(same_partition(res.pids[j], ora[j]) for j in range(5))
    print("oracle validation: OK")


if __name__ == "__main__":
    main()
