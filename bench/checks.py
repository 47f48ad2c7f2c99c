"""The comparison that decides ``correct``: what the window's builds
returned against the reference's partition of the same graph.

Every build's block counts are compared level by level (a history of
another length, as a fixpoint found at another iteration gives, counts
the missing levels whole); the pid histories of a sample of builds drawn
from the seed are compared level by level as partitions (the program
names its blocks by the rank of a hash, the reference by the rank of a
signature, so equal partitions are equal up to renaming).  Every number
is exact, so every limit is 0.
"""
from __future__ import annotations

import random

import torch

SAMPLE = 2  # builds whose pid histories are judged
LIMITS = {"count_gap": 0, "partition_gap": 0}


class Sampler:
    """A reservoir of ``SAMPLE`` builds, drawn from the seed."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self.seen = 0
        self.kept = []  # (build index, pid history)

    def offer(self, pids) -> None:
        if len(self.kept) < SAMPLE:
            self.kept.append((self.seen, pids))
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < SAMPLE:
                self.kept[j] = (self.seen, pids)
        self.seen += 1


def _count_gap(counts, ref_counts) -> int:
    n = max(len(counts), len(ref_counts))
    a = list(counts) + [0] * (n - len(counts))
    b = list(ref_counts) + [0] * (n - len(ref_counts))
    return max(abs(int(x) - int(y)) for x, y in zip(a, b))


def partition_gap(pids, ref_pids, device) -> int:
    """Nodes split or merged against the reference, summed over levels:
    at each level 2 * (distinct (program, reference) pid pairs) minus the
    blocks of each side, which is 0 exactly when the two partitions are
    one up to renaming.  A level one side lacks counts every node."""
    gap = 0
    for j in range(max(len(pids), len(ref_pids))):
        if j >= len(pids) or j >= len(ref_pids):
            gap += int(ref_pids[0].numel())
            continue
        a = torch.as_tensor(pids[j]).to(device, torch.int64)
        b = ref_pids[j].to(device, torch.int64)
        if a.shape != b.shape:
            gap += int(b.numel())
            continue
        pairs = torch.unique((a << 32) | b).numel()
        gap += 2 * pairs - torch.unique(a).numel() - torch.unique(b).numel()
    return gap


def judge(counts, samples, ref, device) -> tuple:
    """(checks, failed builds): ``counts`` are the block counts of every
    build, ``samples`` (build index, pid history) of the sampled ones,
    ``ref`` the reference's `Partition`."""
    bad = set()
    count_gap = part_gap = 0
    for i, c in enumerate(counts):
        g = _count_gap(c, ref.counts)
        count_gap = max(count_gap, g)
        if g:
            bad.add(i)
    for i, pids in samples:
        g = partition_gap(pids, ref.pids, device)
        part_gap = max(part_gap, g)
        if g:
            bad.add(i)
    values = {"count_gap": count_gap, "partition_gap": part_gap}
    checks = {name: {"value": values[name], "limit": LIMITS[name]}
              for name in LIMITS}
    return checks, len(bad)


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
