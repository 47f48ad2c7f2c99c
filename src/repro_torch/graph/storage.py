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
package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
        order = np.lexsort((dst, elabel, src))
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

    def in_order(self) -> np.ndarray:
        """Permutation sorting edges by (dst, src): the analogue of E_tts."""
        return np.lexsort((self.src, self.dst))

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
        return Graph.from_edges(
            self.node_labels,
            np.concatenate([self.src, np.atleast_1d(src).astype(np.int32)]),
            np.concatenate([self.dst, np.atleast_1d(dst).astype(np.int32)]),
            np.concatenate([self.elabel, np.atleast_1d(elabel).astype(np.int32)]),
        )

    def with_edges_removed(self, src, dst, elabel) -> "Graph":
        rm = set(zip(np.atleast_1d(src).tolist(), np.atleast_1d(elabel).tolist(),
                     np.atleast_1d(dst).tolist()))
        keep = np.array(
            [(s, l, t) not in rm
             for s, l, t in zip(self.src.tolist(), self.elabel.tolist(),
                                self.dst.tolist())], dtype=bool)
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
