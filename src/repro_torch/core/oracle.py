"""Exact reference oracle for k-bisimulation (Definition 1), pure Python.

Mirrors the paper's validation methodology (§5.2): they compare Algorithm 1
against the classic full-bisimulation algorithm of Smolka et al. [24] and
against Hellings et al. [15] on DAGs. Here the oracle computes partition ids
by materializing the *actual signature objects* (frozensets of
(eLabel, pid) pairs) with exact equality — no hashing — so engine/oracle
agreement also certifies that 64-bit hashing introduced no collisions on the
tested graphs.

The port's own copy of `repro.core.oracle` (pure numpy/Python), so a
build on the card is checked without importing the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..graph.storage import Graph


def oracle_pids(graph: Graph, k: int, *, counting: bool = False,
                early_stop: bool = True) -> list:
    """Exact pid history [j][node] for j = 0..k (early-stopped like Alg. 1).

    counting=False: set semantics (Definition 3, the paper's k-bisimulation).
    counting=True : multiset semantics (counting bisimulation) — the oracle
                    for the sort-free 'multiset' engine mode.
    """
    n = graph.num_nodes
    out = [[] for _ in range(n)]
    for s, t, l in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.elabel.tolist()):
        out[s].append((l, t))

    labels = graph.node_labels.tolist()
    uniq = {}
    pid0 = [uniq.setdefault(lab, len(uniq)) for lab in labels]
    history = [pid0]
    counts = [len(uniq)]

    pid_prev = pid0
    for _ in range(1, k + 1):
        uniq = {}
        pid_new = [0] * n
        for u in range(n):
            pairs = [(l, pid_prev[t]) for (l, t) in out[u]]
            if counting:
                key = (pid0[u], tuple(sorted(pairs)))
            else:
                key = (pid0[u], frozenset(pairs))
            pid_new[u] = uniq.setdefault(key, len(uniq))
        history.append(pid_new)
        counts.append(len(uniq))
        if early_stop and counts[-1] == counts[-2]:
            break
        pid_prev = pid_new
    return [np.asarray(h, dtype=np.int32) for h in history]


def is_k_bisimilar(graph: Graph, u: int, v: int, k: int) -> bool:
    """Direct recursive check of Definition 1 (exponential; tiny graphs only).

    Used as a second, structurally independent oracle in property tests.
    """
    out = [[] for _ in range(graph.num_nodes)]
    for s, t, l in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.elabel.tolist()):
        out[s].append((l, t))
    labels = graph.node_labels.tolist()

    def bisim(a: int, b: int, j: int) -> bool:
        if labels[a] != labels[b]:
            return False
        if j == 0:
            return True
        for (l, a2) in out[a]:
            if not any(l == l2 and bisim(a2, b2, j - 1) for (l2, b2) in out[b]):
                return False
        for (l, b2) in out[b]:
            if not any(l == l2 and bisim(a2, b2, j - 1) for (l2, a2) in out[a]):
                return False
        return True

    return bisim(u, v, k)
