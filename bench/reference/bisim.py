"""The plain reference: the k-bisimulation partition of a graph, worked
out edge by edge with plain tensor operations.

Definition 3 of the paper: pId_0 ranks the node labels; at iteration j a
node's signature is its label class with the set of (eLabel, pId_{j-1}(t))
pairs of its out-edges, and pId_j ranks the signatures.  Iterations stop
at k, or at the first j whose block count equals j - 1's (Prop. 7).

A set is named by its size and by two sums, each over its distinct pairs
of an independent 64-bit mix of the pair (splitmix64's finaliser, with a
salt of its own), so that no sort of each node's pairs is needed, however
long its row: two different sets of one node class share all three with
a chance of about 2**-128.  The program's signatures are 64 bits of
another family (two 32-bit mix-hashes of its own, folded over its sorted
lanes), so the two share the definition and nothing of its code.

``semantics="multiset"`` keeps repeated pairs: the counting variant that
a program breaking the configuration's set semantics would compute.

Plain PyTorch on any device; imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bench.graphs import bits

SALTS = (0x9E3779B97F4A7C15, 0xD1B54A32D192ED03)
CHUNK = 1 << 26  # lanes mixed at a time, to bound the temporaries


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1, _M2 = _i64(0xBF58476D1CE4E5B9), _i64(0x94D049BB133111EB)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix(x: torch.Tensor, salt: int) -> torch.Tensor:
    """splitmix64's finaliser of ``x + salt``, modulo 2**64 in int64."""
    x = x + _i64(salt)
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


@dataclasses.dataclass
class Partition:
    pids: list                  # int32 [N] tensor a level, 0..k_eff
    counts: list                # blocks a level
    converged_at: Optional[int]


def dense_rank(x: torch.Tensor):
    """(rank int64 [n], distinct values): equal values, equal ranks."""
    uniq, inv = torch.unique(x, sorted=True, return_inverse=True)
    return inv, uniq.numel()


def rank_rows(*cols):
    """(dense ranks, distinct rows) of the rows of equally long int64
    columns."""
    rank, count = dense_rank(cols[0])
    for c in cols[1:]:
        r, _ = dense_rank(c)
        rank, count = dense_rank((rank << 32) | r)  # both below 2**31
    return rank, count


def _signatures(key, pair_bits: int, num_nodes: int):
    """Each node's (size, first sum, second sum) over its (src, pair)
    keys."""
    dev = key.device
    size = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    sums = [torch.zeros_like(size) for _ in SALTS]
    for lo in range(0, key.numel(), CHUNK):
        part = key[lo:lo + CHUNK]
        src, pair = part >> pair_bits, part & ((1 << pair_bits) - 1)
        size.index_add_(0, src, torch.ones_like(src))
        for h, salt in zip(sums, SALTS):
            h.index_add_(0, src, mix(pair, salt))
    return size, *sums


def partition(cols: dict, k: int, *, early_stop: bool = True,
              semantics: str = "set") -> Partition:
    """pId_0..pId_k_eff of the graph whose int32 columns ``cols`` holds
    (``node_labels``, ``src``, ``dst``, ``elabel``), on their device."""
    if semantics not in ("set", "multiset"):
        raise ValueError(f"unknown semantics {semantics}")
    n = cols["node_labels"].numel()
    src, dst, lab = cols["src"], cols["dst"], cols["elabel"]
    m = src.numel()
    lab_min = int(lab.min()) if m else 0
    nb = bits(n - 1)
    lb = bits(int(lab.max()) - lab_min) if m else 0
    cls, count = dense_rank(cols["node_labels"].to(torch.int64))
    pids, counts, converged = [cls.to(torch.int32)], [count], None
    pid = cls
    for j in range(1, k + 1):
        key = torch.empty(m, dtype=torch.int64, device=src.device)
        for lo in range(0, m, CHUNK):
            hi = min(lo + CHUNK, m)
            key[lo:hi] = ((src[lo:hi].to(torch.int64) << (lb + nb))
                          | ((lab[lo:hi].to(torch.int64) - lab_min) << nb)
                          | pid[dst[lo:hi].to(torch.int64)])
        if semantics == "set":
            key = torch.unique(key)
        sig = _signatures(key, lb + nb, n)
        del key
        pid, count = rank_rows(cls, *sig)
        del sig
        pids.append(pid.to(torch.int32))
        counts.append(count)
        if early_stop and count == counts[-2]:
            converged = j
            break
    return Partition(pids, counts, converged)
