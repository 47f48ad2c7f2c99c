"""The Kronecker family of the Graph 500 benchmark, drawn on the card from
``--seed``: the specification's generator, edge by edge.

Configuration keys (the specification's names):

* ``scale``: 2**scale vertices;
* ``edgefactor``: edgefactor * 2**scale edges drawn;
* ``initiator``: [A, B, C, D], the probabilities of the four quadrants.
  Each edge picks one quadrant a bit of its (start, end) vertex pair,
  ``scale`` times: the start bit is 1 with probability C + D, and the end
  bit then 1 with probability B / (A + B) or D / (C + D);
* the vertices are then renamed by a random permutation.

The edges are read as directed, start -> end, as they are drawn; one
node label and one edge label.  The graph's edges are a set: duplicate
draws are kept once, self-loops are kept.
"""
from __future__ import annotations

import torch

from bench.graphs import unique_edges

CHUNK = 1 << 26  # edges drawn at a time, to bound the draw's memory


def sizes(cfg: dict) -> dict:
    n = 1 << cfg["scale"]
    return {"nodes": n, "edges_drawn": cfg["edgefactor"] * n}


def _bits(g, count: int, scale: int, initiator, device):
    """(start, end) of ``count`` edges, one quadrant a bit."""
    a, b, c, d = initiator
    start_one, end_if_0, end_if_1 = c + d, b / (a + b), d / (c + d)
    i = torch.zeros(count, dtype=torch.int64, device=device)
    j = torch.zeros(count, dtype=torch.int64, device=device)
    for bit in range(scale):
        ib = torch.rand(count, generator=g, device=device) < start_one
        p_end = torch.where(ib, end_if_1, end_if_0)
        jb = torch.rand(count, generator=g, device=device) < p_end
        i |= ib.to(torch.int64) << bit
        j |= jb.to(torch.int64) << bit
    return i, j


def generate(cfg: dict, seed: int, device) -> dict:
    """The graph's int32 columns on ``device``, edges canonical."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    s = sizes(cfg)
    n, m, scale = s["nodes"], s["edges_drawn"], cfg["scale"]
    perm = torch.randperm(n, generator=g, device=device)
    key = torch.empty(m, dtype=torch.int64, device=device)
    for lo in range(0, m, CHUNK):
        i, j = _bits(g, min(CHUNK, m - lo), scale, cfg["initiator"], device)
        key[lo:lo + i.numel()] = (perm[i] << scale) | perm[j]
        del i, j
    del perm
    src, dst, elabel = unique_edges(key, num_nodes=n, num_edge_labels=1)
    return {"node_labels": torch.zeros(n, dtype=torch.int32, device=device),
            "src": src, "dst": dst, "elabel": elabel}
