"""State carried across between the JAX package and the port.

This system has no weights: its state is the graph, the pid history and the
per-level signature stores.  These functions move that state between the
port's objects and plain numpy arrays, the form in which a result of the
JAX package (`repro.core.BisimResult`) is handed over, and back.  The
maintenance slice starts from this state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph.storage import Graph
from .partition import BisimResult
from .sig_store import SigStore


def graph_from_numpy(node_labels, src, dst, elabel) -> Graph:
    """A port `Graph` from numpy columns, kept in the order given (a graph
    that is already canonical stays bit-identical)."""
    return Graph(np.asarray(node_labels), np.asarray(src), np.asarray(dst),
                 np.asarray(elabel))


def result_to_numpy(res: BisimResult) -> dict:
    """A result's integer state as numpy arrays: pids, counts,
    converged_at (-1 for None), k_requested, next_pid, and per-level store
    columns ``store_keys`` / ``store_pids`` (lists; absent without stores).
    """
    out = {
        "pids": np.asarray(res.pids, dtype=np.int32),
        "counts": np.asarray(res.counts, dtype=np.int64),
        "converged_at": np.int64(-1 if res.converged_at is None
                                 else res.converged_at),
        "k_requested": np.int64(res.k_requested),
    }
    if res.stores is not None:
        out["next_pid"] = np.asarray(res.next_pid, dtype=np.int64)
        out["store_keys"] = [np.asarray(s.keys) for s in res.stores]
        out["store_pids"] = [np.asarray(s.pids) for s in res.stores]
    return out


def result_from_numpy(pids, counts, converged_at, k_requested, *,
                      next_pid=None, store_keys: Optional[list] = None,
                      store_pids: Optional[list] = None,
                      stats: Optional[list] = None) -> BisimResult:
    """A port `BisimResult` from numpy fields (the inverse of
    `result_to_numpy`; ``converged_at`` None or < 0 means not converged).
    Store columns must already be sorted, as every SigStore keeps them."""
    conv = None if converged_at is None or int(converged_at) < 0 \
        else int(converged_at)
    stores = None
    if store_keys is not None:
        stores = [SigStore(k, p, presorted=True)
                  for k, p in zip(store_keys, store_pids)]
    return BisimResult(
        pids=np.asarray(pids, dtype=np.int32),
        counts=[int(c) for c in counts], stats=list(stats or []),
        converged_at=conv, k_requested=int(k_requested), stores=stores,
        next_pid=None if next_pid is None else [int(p) for p in next_pid])
