"""Graph columns as the benchmark hands them to the program and to the
reference: int32 tensors, the edges distinct and in (src, elabel, dst)
order, the canonical order of the program's `Graph`.

Plain PyTorch; imports nothing of the program, so the generators and the
reference share it.
"""
from __future__ import annotations

import torch

COLUMNS = ("node_labels", "src", "dst", "elabel")


def bits(n: int) -> int:
    """Bits that hold every value in [0, n]."""
    return max(int(n), 0).bit_length()


def unique_edges(key, *, num_nodes: int, num_edge_labels: int):
    """The distinct (src, elabel, dst) triples in ascending order, as three
    int32 columns, from their packed int64 keys (src above elabel above
    dst, each in the bits its range needs): one sorted unique."""
    nb, lb = bits(num_nodes - 1), bits(num_edge_labels - 1)
    if 2 * nb + lb > 63:
        raise ValueError(f"{num_nodes} nodes and {num_edge_labels} edge "
                         "labels do not pack into one int64 key")
    key = torch.unique(key)  # sorted
    cols = ((key >> (lb + nb)).to(torch.int32),
            (key & ((1 << nb) - 1)).to(torch.int32),
            ((key >> nb) & ((1 << lb) - 1)).to(torch.int32))
    return cols  # src, dst, elabel


def fingerprint(cols: dict) -> list:
    """Sizes and position-weighted sums of the columns: enough to tell the
    graph that set-up made from the one the reference makes again."""
    out = []
    for name in COLUMNS:
        c = cols[name].to(torch.int64)
        w = torch.arange(c.numel(), device=c.device, dtype=torch.int64) % 65521
        out += [int(c.numel()), int((c * (w + 1)).sum())]
    return out
