"""Synthetic graph generators mirroring the paper's dataset families.

The paper evaluates on RDF-ish real graphs (Jamendo..Twitter), synthetic
structured RDF (SP2B, BSBM), and two adversarial maintenance datasets:
Dbest (full k-ary tree, edges parent->child) and Dworst (complete graph).
These generators reproduce each family's *shape* at configurable scale.

The port's own copy of `repro.graph.generators`: the same numpy streams
from the same seeds, so both packages build bit-identical graphs.
"""
from __future__ import annotations

import numpy as np

from .storage import Graph


def random_graph(num_nodes: int, num_edges: int, num_node_labels: int = 4,
                 num_edge_labels: int = 3, seed: int = 0) -> Graph:
    """Uniform random labeled multigraph (dedup'd)."""
    rng = np.random.default_rng(seed)
    node_labels = rng.integers(0, num_node_labels, num_nodes, dtype=np.int32)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    lab = rng.integers(0, num_edge_labels, num_edges, dtype=np.int32)
    return Graph.from_edges(node_labels, src, dst, lab)


def powerlaw_graph(num_nodes: int, num_edges: int, num_node_labels: int = 4,
                   num_edge_labels: int = 3, alpha: float = 1.2,
                   seed: int = 0) -> Graph:
    """Zipf-degree graph: the Twitter/WikiLinks-like family (few hub nodes
    with very large out-degree -> long signatures, many partition blocks)."""
    rng = np.random.default_rng(seed)
    node_labels = rng.integers(0, num_node_labels, num_nodes, dtype=np.int32)
    # Zipf ranks for targets (hubs attract edges), uniform sources.
    ranks = rng.zipf(alpha + 1.0, size=num_edges)
    dst = ((ranks - 1) % num_nodes).astype(np.int32)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    lab = rng.integers(0, num_edge_labels, num_edges, dtype=np.int32)
    return Graph.from_edges(node_labels, src, dst, lab)


def random_dag(num_nodes: int, num_edges: int, num_node_labels: int = 4,
               num_edge_labels: int = 3, seed: int = 0) -> Graph:
    """Random DAG: the family used to validate against Hellings et al. [15]."""
    rng = np.random.default_rng(seed)
    node_labels = rng.integers(0, num_node_labels, num_nodes, dtype=np.int32)
    a = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    b = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    keep = a != b
    a, b = a[keep], b[keep]
    src, dst = np.minimum(a, b), np.maximum(a, b)  # edges point to larger id
    lab = rng.integers(0, num_edge_labels, src.shape[0], dtype=np.int32)
    return Graph.from_edges(node_labels, src, dst, lab)


def kary_tree(branching: int, height: int) -> Graph:
    """Dbest: full k-ary tree, edges parent -> child, one node/edge label.

    Adding an edge into a leaf changes no signature -> maintenance best case.
    """
    sizes = [branching ** h for h in range(height + 1)]
    num_nodes = sum(sizes)
    node_labels = np.zeros(num_nodes, dtype=np.int32)
    parents = np.arange(sum(sizes[:-1]), dtype=np.int64)
    children = np.arange(1, num_nodes, dtype=np.int64)
    src = np.repeat(parents, branching).astype(np.int32)[: children.shape[0]]
    dst = children.astype(np.int32)
    lab = np.zeros(dst.shape[0], dtype=np.int32)
    return Graph.from_edges(node_labels, src, dst, lab)


def complete_graph(num_nodes: int) -> Graph:
    """Dworst: complete digraph (no self loops), all edges labeled x(=0).

    Adding one y(=1)-labeled edge invalidates every node each iteration ->
    maintenance worst case.
    """
    idx = np.arange(num_nodes, dtype=np.int32)
    src = np.repeat(idx, num_nodes)
    dst = np.tile(idx, num_nodes)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lab = np.zeros(src.shape[0], dtype=np.int32)
    return Graph.from_edges(np.zeros(num_nodes, dtype=np.int32), src, dst, lab)


def structured_graph(num_entities: int, seed: int = 0) -> Graph:
    """SP2B/BSBM-like highly structured RDF shape: entity layers connected by
    a small fixed schema of edge labels.  Reaches full bisimulation within a
    few iterations with tiny partition counts (paper Fig. 3a, BSBM/SP2B)."""
    rng = np.random.default_rng(seed)
    # Layers: authors -> papers -> venues ; papers -> papers (cites)
    n_auth = num_entities
    n_pap = num_entities * 2
    n_ven = max(4, num_entities // 50)
    node_labels = np.concatenate([
        np.full(n_auth, 0, np.int32), np.full(n_pap, 1, np.int32),
        np.full(n_ven, 2, np.int32)])
    auth = np.arange(n_auth, dtype=np.int32)
    pap = n_auth + np.arange(n_pap, dtype=np.int32)
    # each paper has 1-3 authors (edge label 0: creator)
    n_author_edges = n_pap * 2
    e_src = [np.repeat(pap, 2)]
    e_dst = [rng.integers(0, n_auth, n_author_edges, dtype=np.int32)]
    e_lab = [np.zeros(n_author_edges, dtype=np.int32)]
    # each paper -> venue (label 1)
    e_src.append(pap)
    e_dst.append(n_auth + n_pap + rng.integers(0, n_ven, n_pap, dtype=np.int32))
    e_lab.append(np.ones(n_pap, dtype=np.int32))
    # citations (label 2): highly regular — papers cite a handful of
    # "landmark" papers, so cite-target *sets* collapse to few blocks and
    # the partition converges in a few iterations with tiny counts
    # (the BSBM/SP2B behavior in paper Fig. 3a).
    n_land = 8
    n_cite = n_pap * 3
    e_src.append(n_auth + rng.integers(n_land, n_pap, n_cite,
                                       dtype=np.int32))
    e_dst.append(n_auth + rng.integers(0, n_land, n_cite, dtype=np.int32))
    e_lab.append(np.full(n_cite, 2, np.int32))
    return Graph.from_edges(node_labels, np.concatenate(e_src),
                            np.concatenate(e_dst), np.concatenate(e_lab))
