"""Query shapes and the two host evaluators.

The port's copy of `repro.quotient.queries` (host numpy, unchanged).
`eval_ref` is the numpy reference the engine's device waves must match
bit for bit (same masks, same expansion); `eval_brute` evaluates the
same query directly on the original `Graph`: the ground truth both are
tested against.  Exactness: a path of length m answered at level j is
exact whenever m <= j (package docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..graph.storage import Graph

# want-label sentinels for the batched evaluator's fixed slots: real
# node labels are >= 0 and a vacated block's label is -1, so neither
# sentinel can collide with a stored label.
WANT_ALL = -2     # unconstrained endpoint: every block matches
WANT_NONE = -3    # padding slot: no block matches


@dataclasses.dataclass(frozen=True)
class LabelPath:
    """Nodes with an outgoing path spelling `labels`, answered at
    quotient level `level` (default: len(labels), the smallest exact
    level)."""

    labels: Tuple[int, ...]
    level: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ReachTemplate:
    """`LabelPath` with optional node-label constraints on the source
    and/or target endpoint."""

    labels: Tuple[int, ...]
    src_label: Optional[int] = None
    tgt_label: Optional[int] = None
    level: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PointLookup:
    """pId_level(node) + block size via the extent runs."""

    node: int
    level: int


@dataclasses.dataclass(frozen=True)
class PointAnswer:
    node: int
    level: int
    pid: int
    block_size: int


def normalize_query(q, k: int):
    """(labels tuple, src_label, tgt_label, level) with validation of
    the exactness precondition 1 <= len(labels) <= level <= k."""
    if isinstance(q, LabelPath):
        labels, src_l, tgt_l, level = tuple(q.labels), None, None, q.level
    elif isinstance(q, ReachTemplate):
        labels, src_l, tgt_l, level = (tuple(q.labels), q.src_label,
                                       q.tgt_label, q.level)
    else:
        raise TypeError(f"not a path query: {q!r}")
    m = len(labels)
    if m < 1:
        raise ValueError("label path must have at least one hop")
    level = m if level is None else int(level)
    if not m <= level <= k:
        raise ValueError(
            f"need len(labels)={m} <= level={level} <= k={k} for an "
            "exact quotient answer")
    for c in (src_l, tgt_l):
        if c is not None and c < 0:
            raise ValueError("label constraints must be >= 0")
    if any(l < 0 for l in labels):
        raise ValueError("edge labels must be >= 0")
    return labels, src_l, tgt_l, level


# ------------------------------------------------------------- expansion
def expand_blocks(index, level: int, block_mask: np.ndarray,
                  src_label: Optional[int]) -> np.ndarray:
    """Level-`level` block mask -> ascending member node ids, with the
    optional source node-label filter.  Shared by the engine and the
    reference evaluator (host-side in both), so engine/ref parity is
    decided entirely by the masks."""
    pids = np.flatnonzero(np.asarray(block_mask))
    if src_label is not None and pids.size:
        pids = pids[index.labels[level][pids] == src_label]
    return index.runs[level].expand(pids)


def point_lookup(index, node: int, level: int) -> PointAnswer:
    if not 0 <= level <= index.k:
        raise ValueError(f"level out of range: {level}")
    runs = index.runs[level]
    pid = int(runs.pid_of([node])[0])
    return PointAnswer(int(node), int(level), pid, runs.block_size(pid))


# ------------------------------------------------------------- reference
def eval_ref(index, q) -> np.ndarray:
    """Numpy reference: backward block-mask chaining down the level
    ladder Q_j .. Q_{j-m+1}, then extent expansion."""
    if isinstance(q, PointLookup):
        return point_lookup(index, q.node, q.level)
    labels, src_l, tgt_l, j = normalize_query(q, index.k)
    m = len(labels)
    base = index.labels[j - m]
    mask = (np.ones(index.counts[j - m], dtype=bool) if tgt_l is None
            else base == tgt_l)
    for t in range(m - 1, -1, -1):
        lev = j - t
        L = index.levels[lev]
        hit = mask[L.dst] & (L.elabel == labels[t])
        mask = np.zeros(index.counts[lev], dtype=bool)
        mask[L.src[hit]] = True
    return expand_blocks(index, j, mask, src_l)


# ----------------------------------------------------------- brute force
def eval_brute(graph: Graph, q, pid_history=None) -> np.ndarray:
    """Ground truth on the original graph: backward node-set chaining
    over the raw edge list.  `pid_history` (list of per-level pid
    columns) is only needed for `PointLookup`."""
    if isinstance(q, PointLookup):
        if pid_history is None:
            raise ValueError("PointLookup brute force needs pid_history")
        col = np.asarray(pid_history[q.level], dtype=np.int64)
        pid = int(col[q.node])
        return PointAnswer(q.node, q.level,
                           pid, int((col == pid).sum()))
    labels, src_l, tgt_l, _ = normalize_query(
        q, max(len(q.labels), q.level or 0))
    n = graph.num_nodes
    mask = (np.ones(n, dtype=bool) if tgt_l is None
            else graph.node_labels == tgt_l)
    for lab in reversed(labels):
        sel = (graph.elabel == lab) & mask[graph.dst]
        mask = np.zeros(n, dtype=bool)
        mask[graph.src[sel]] = True
    if src_l is not None:
        mask &= graph.node_labels == src_l
    return np.flatnonzero(mask).astype(np.int64)
