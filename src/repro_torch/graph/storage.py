"""Graph storage: the framework analogue of the paper's N_t / E_t tables.

The paper stores the graph as two disk-resident column tables:
  N_t(nId, nLabel, pId_0, pId_old, pId_new)   and   E_t(sId, eLabel, tId, pId_old_tId)
kept in several sort orders (E_tst by (sId,tId), E_tts by (tId,sId)).

Here the analogue is a struct-of-arrays `Graph` whose edge columns are kept
canonically sorted by (src, elabel, dst) — the sort order Algorithm 1 needs —
plus CSR offsets for both directions (the analogue of the E_tst / E_tts
copies used by the maintenance algorithms).

The port keeps its own copy of `repro.graph.storage` (host-side numpy
input, identical canonicalisation) so that it imports nothing of the JAX
package.  Its sorts and its edge removal are vectorised (`lexsort_order`,
`_rows_in`): the same permutations and rows, without `np.lexsort`'s
column passes or a Python set, which an update of a graph with tens of
millions of edges would otherwise pay.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _spans(*groups):
    """(offset, bits) of each integer column, over the rows of every
    group of parallel columns: its minimum and the width of its range."""
    out = []
    for cols in zip(*groups):
        cols = [c for c in cols if c.shape[0]]
        lo = min(int(c.min()) for c in cols)
        out.append((lo, (max(int(c.max()) for c in cols) - lo).bit_length()))
    return out


def _fused(cols, spans) -> np.ndarray:
    """One int64 key a row: the columns packed least significant first."""
    key = np.zeros(cols[0].shape[0], np.int64)
    shift = 0
    for c, (lo, bits) in zip(cols, spans):
        key |= (np.asarray(c).astype(np.int64) - lo) << shift
        shift += bits
    return key


def _fits(spans) -> bool:
    return sum(bits for _, bits in spans) <= 63


def lexsort_order(keys, device=None) -> np.ndarray:
    """The permutation ``np.lexsort(keys)`` returns (last key primary,
    equal rows in their input order), by one stable sort of a fused int64
    key when the keys' ranges fit 63 bits together: torch's, on the CPU
    or on ``device``."""
    cols = [np.asarray(k) for k in keys]
    if cols[0].shape[0] == 0:
        return np.lexsort(cols)
    spans = _spans(cols)
    if not _fits(spans):
        return np.lexsort(cols)
    key = torch.from_numpy(_fused(cols, spans)).to(device or "cpu")
    return torch.sort(key, stable=True).indices.cpu().numpy()


def _rows_in(cols, probe) -> np.ndarray:
    """Which rows of the parallel integer columns ``cols`` equal some row
    of ``probe`` (bool [rows])."""
    spans = _spans(cols, probe)
    if not _fits(spans):
        rm = set(zip(*(np.asarray(c).tolist() for c in probe)))
        return np.array([r in rm for r in zip(*(np.asarray(c).tolist()
                                                for c in cols))], dtype=bool)
    key = _fused(cols, spans)
    want = np.unique(_fused(probe, spans))
    idx = np.minimum(np.searchsorted(want, key), want.shape[0] - 1)
    return want[idx] == key


@dataclasses.dataclass
class Graph:
    """Directed node- and edge-labeled graph <N, E, lambda_N, lambda_E>."""

    node_labels: np.ndarray  # int32 [N]
    src: np.ndarray          # int32 [E], sorted (src, elabel, dst)
    dst: np.ndarray          # int32 [E]
    elabel: np.ndarray       # int32 [E]

    @property
    def num_nodes(self) -> int:
        return int(self.node_labels.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def __post_init__(self):
        self.node_labels = np.asarray(self.node_labels, dtype=np.int32)
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.elabel = np.asarray(self.elabel, dtype=np.int32)
        if self.src.shape != self.dst.shape or self.src.shape != self.elabel.shape:
            raise ValueError("edge columns must have identical shapes")
        if self.num_edges:
            if self.src.min() < 0 or self.src.max() >= self.num_nodes:
                raise ValueError("src out of range")
            if self.dst.min() < 0 or self.dst.max() >= self.num_nodes:
                raise ValueError("dst out of range")

    # ---------------------------------------------------------------- builds
    @staticmethod
    def from_edges(node_labels, src, dst, elabel, *, dedup: bool = True) -> "Graph":
        """Canonicalize: sort edges by (src, elabel, dst); drop exact duplicate
        (s,l,t) triples (they are redundant under the paper's set semantics)."""
        node_labels = np.asarray(node_labels, dtype=np.int32)
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        elabel = np.asarray(elabel, dtype=np.int32)
        order = lexsort_order((dst, elabel, src))
        src, dst, elabel = src[order], dst[order], elabel[order]
        if dedup and src.size:
            keep = np.ones(src.shape[0], dtype=bool)
            keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1]) | (
                elabel[1:] != elabel[:-1])
            src, dst, elabel = src[keep], dst[keep], elabel[keep]
        return Graph(node_labels, src, dst, elabel)

    # ----------------------------------------------------------------- CSR
    def out_offsets(self) -> np.ndarray:
        """CSR row offsets over the canonical (src-sorted) edge order: the
        analogue of E_tst."""
        counts = np.bincount(self.src, minlength=self.num_nodes)
        off = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        return off

    def in_order(self, device=None) -> np.ndarray:
        """Permutation sorting edges by (dst, src): the analogue of E_tts
        (sorted on ``device`` when one is given)."""
        return lexsort_order((self.src, self.dst), device)

    def in_offsets(self, in_order: Optional[np.ndarray] = None) -> np.ndarray:
        counts = np.bincount(self.dst, minlength=self.num_nodes)
        off = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        return off

    # ------------------------------------------------------------------ IO
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, node_labels=self.node_labels, src=self.src, dst=self.dst,
            elabel=self.elabel)

    @staticmethod
    def load(path: str) -> "Graph":
        z = np.load(path)
        return Graph(z["node_labels"], z["src"], z["dst"], z["elabel"])

    def to_ooc(self, root: str, *, chunk_nodes: int = 1 << 16,
               chunk_edges: int = 1 << 16):
        """Spill to chunked on-disk N_t/E_t tables
        (`repro_torch.exmem.OocGraph`); inverse of `OocGraph.to_memory()`."""
        from ..exmem.tables import OocGraph  # avoid circular import
        return OocGraph.from_graph(self, root, chunk_nodes=chunk_nodes,
                                   chunk_edges=chunk_edges)

    # --------------------------------------------------------------- edits
    def with_edges_added(self, src, dst, elabel) -> "Graph":
        """The graph with these edges added, canonical (sorted, no
        duplicate triple).  A canonical graph takes the new edges by a
        merge; the rest re-sorts the union, as the reference does."""
        new = Graph.from_edges(self.node_labels, np.atleast_1d(src),
                               np.atleast_1d(dst), np.atleast_1d(elabel))
        cols = (self.dst, self.elabel, self.src)  # least significant first
        new_cols = (new.dst, new.elabel, new.src)
        spans = (_spans(cols, new_cols) if self.num_edges and new.num_edges
                 else None)
        key = _fused(cols, spans) if spans and _fits(spans) else None
        if key is None or (key[1:] <= key[:-1]).any():
            # not canonical (or too wide to pack): sort the union
            return Graph.from_edges(self.node_labels, *(
                np.concatenate([old, add]) for old, add in (
                    (self.src, new.src), (self.dst, new.dst),
                    (self.elabel, new.elabel))))
        new_key = _fused(new_cols, spans)
        pos = np.searchsorted(key, new_key)
        fresh = key[np.minimum(pos, key.shape[0] - 1)] != new_key
        pos = pos[fresh]
        return Graph(self.node_labels,
                     *(np.insert(old, pos, add[fresh]) for old, add in (
                         (self.src, new.src), (self.dst, new.dst),
                         (self.elabel, new.elabel))))

    def with_edges_removed(self, src, dst, elabel) -> "Graph":
        probe = [np.atleast_1d(c) for c in (src, elabel, dst)]
        if self.num_edges == 0 or probe[0].size == 0:
            return Graph(self.node_labels, self.src, self.dst, self.elabel)
        keep = ~_rows_in((self.src, self.elabel, self.dst), probe)
        return Graph(self.node_labels, self.src[keep], self.dst[keep],
                     self.elabel[keep])

    def with_nodes_added(self, labels) -> "Graph":
        labels = np.atleast_1d(labels).astype(np.int32)
        return Graph(np.concatenate([self.node_labels, labels]), self.src,
                     self.dst, self.elabel)


def paper_example_graph() -> Graph:
    """The 6-node social-network example from Figure 1 of the paper.

    Nodes 1,2 have label M(=0); nodes 3..6 label P(=1). Edge labels:
    l(ikes)=0, w(orks for)=1. Node ids are shifted to 0-based.
    """
    #            (3,l,1) (1,w,2) (2,w,2) (5,l,2) (4,l,3) (1,l,4) (2,l,6)
    src = np.array([2, 0, 1, 4, 3, 0, 1])
    dst = np.array([0, 1, 1, 1, 2, 3, 5])
    lab = np.array([0, 1, 1, 0, 0, 0, 0])
    node_labels = np.array([0, 0, 1, 1, 1, 1])
    return Graph.from_edges(node_labels, src, dst, lab)
