"""Distributed Build_Bisim over a `torch.distributed` process group.

The port of `repro.core.distributed`.  The reference runs one program
over a device mesh (``shard_map``); here every rank of a process group
runs `build_bisim_distributed` on its own device, and the mesh's
collectives become the group's:

  * nodes are range-sharded across ranks (rank r owns ``n_loc``
    contiguous node ids) and edges are sharded by the owner of their
    source, so every node's out-edge segment is local to one rank;
  * the join E_t ⋈ N_t on tId (line 10 of Algorithm 1) is an all-gather
    of the pid column followed by a local gather;
  * the local fold runs through `signatures.fold_lanes` and
    `kernels.sig_fold.frontier_sig_fold`: the Hopper ``fold_flat`` kernel
    on a CUDA tensor, its plain version on a CPU tensor (the reference
    folds with plain ``segment_sum``);
  * the signature store S is a distributed dense ranking:
      - ``ranking='allgather'``: all-gather every signature and rank the
        full array on every rank (8 bytes a node a rank);
      - ``ranking='bucketed'``: route each signature to rank
        ``sig_hi % D`` by all-to-all, rank within the bucket, offset by
        the unique counts of lower ranks (one int a rank, all-gathered)
        and route the ranks back by all-to-all.

Each signature travels as one fused int64 key (`signatures.fuse_u32_pair`,
whose signed order is the unsigned (hi, lo) order), so the bytes on the
wire are the reference's 8 a signature.  Pid histories, counts,
``converged_at``, the `IterationStats` byte columns and the overflow error
equal the reference's at the same number of ranks as devices.

The ranks' collectives go through `_all_gather`, `_all_to_all` and
`_all_reduce`, on the rank's device tensors: NCCL takes them on the card,
gloo on the CPU, and gloo also takes CUDA tensors itself (through host
memory), which is how several ranks share one card.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..graph.storage import Graph
from . import signatures as sig
from .partition import BisimResult, IterationStats

RANKINGS = ("allgather", "bucketed")


@dataclasses.dataclass
class ShardedGraph:
    """Host-side padded + owner-sharded representation (built once)."""
    node_labels: np.ndarray  # int32 [N_pad]
    pid0: np.ndarray         # int32 [N_pad]
    src_local: np.ndarray    # int32 [D*e_loc]  (src - owner_base; 0 if invalid)
    dst: np.ndarray          # int32 [D*e_loc]  global target ids
    elabel: np.ndarray       # int32 [D*e_loc]
    valid: np.ndarray        # bool  [D*e_loc]
    num_nodes: int
    n_pad: int
    n_loc: int
    e_loc: int
    num_devices: int
    num_pid0: int

    @property
    def has_padding(self) -> bool:
        return self.n_pad > self.num_nodes


def shard_graph(graph: Graph, num_devices: int) -> ShardedGraph:
    """Partition the graph: owner-sharded edges, range-sharded nodes."""
    n = graph.num_nodes
    d = num_devices
    n_loc = -(-(n + 1) // d)  # >= 1 dummy node so padding always exists
    n_pad = n_loc * d

    sentinel = int(graph.node_labels.max()) + 1 if n else 0
    node_labels = np.full(n_pad, sentinel, dtype=np.int32)
    node_labels[:n] = graph.node_labels
    _, pid0 = np.unique(node_labels, return_inverse=True)
    pid0 = pid0.astype(np.int32)
    num_pid0 = int(pid0.max()) + 1 if n_pad else 0

    owner = graph.src // n_loc
    counts = np.bincount(owner, minlength=d)
    e_loc = max(int(counts.max()), 1)
    src_local = np.zeros((d, e_loc), dtype=np.int32)
    dst = np.zeros((d, e_loc), dtype=np.int32)
    elabel = np.zeros((d, e_loc), dtype=np.int32)
    valid = np.zeros((d, e_loc), dtype=bool)
    # edges are already sorted by src -> contiguous per owner
    starts = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for dev in range(d):
        lo, hi = starts[dev], starts[dev + 1]
        c = hi - lo
        src_local[dev, :c] = graph.src[lo:hi] - dev * n_loc
        dst[dev, :c] = graph.dst[lo:hi]
        elabel[dev, :c] = graph.elabel[lo:hi]
        valid[dev, :c] = True

    return ShardedGraph(
        node_labels=node_labels, pid0=pid0,
        src_local=src_local.reshape(-1), dst=dst.reshape(-1),
        elabel=elabel.reshape(-1), valid=valid.reshape(-1),
        num_nodes=n, n_pad=n_pad, n_loc=n_loc, e_loc=e_loc, num_devices=d,
        num_pid0=num_pid0)


# --------------------------------------------------------------------------
# collectives: each rank passes its own device tensors
# --------------------------------------------------------------------------

def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` concatenated in rank order ([D * len(t)])."""
    out = torch.empty((dist.get_world_size(group), *t.shape), dtype=t.dtype,
                      device=t.device)
    # the list form: every backend takes it, gloo with CUDA tensors too
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out.reshape(-1)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Row i of the [D, capacity] ``t`` goes to rank i; row i of the
    result came from rank i."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise sum of ``t``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


# --------------------------------------------------------------------------
# per-rank steps
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Shard:
    """One rank's part of a `ShardedGraph` on its device: the node slice's
    pId_0 and only the valid lanes of its edge slice (invalid lanes fold
    to nothing, so they are never uploaded)."""
    pid0: torch.Tensor
    src_local: torch.Tensor
    dst: torch.Tensor
    elabel: torch.Tensor
    elabel_range: tuple


def _local_shard(sg: ShardedGraph, rank: int, dev) -> _Shard:
    nodes = slice(rank * sg.n_loc, (rank + 1) * sg.n_loc)
    edges = slice(rank * sg.e_loc, (rank + 1) * sg.e_loc)
    keep = sg.valid[edges]
    cols = [x[edges][keep] for x in (sg.src_local, sg.dst, sg.elabel)]
    labels = cols[2]
    return _Shard(
        torch.from_numpy(sg.pid0[nodes]).to(dev),
        *(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in cols),
        (int(labels.min()), int(labels.max())) if labels.size else (0, 0))


def _local_signatures(pid_full, shard: _Shard, n_loc: int, n_pad: int,
                      mode: str):
    """Signature hashes (hi, lo) of the ``n_loc`` owned nodes, u32 lanes
    in int64: the mode's lanes, the fold (the kernel on the card), the
    final mix with pId_0."""
    from ..kernels.sig_fold import frontier_sig_fold
    a, b, seg, valid, dedup = sig.fold_lanes(
        shard.src_local, shard.dst, shard.elabel, pid_full, num_nodes=n_loc,
        mode=mode, elabel_range=shard.elabel_range, pid_bound=n_pad)
    seg_hi, seg_lo = frontier_sig_fold(a, b, seg, valid, num_sigs=n_loc,
                                       dedup=dedup, presorted=True)
    return sig.hash_triple(seg_hi, seg_lo, shard.pid0)


def _rank_allgather(key, group, rank: int, n_loc: int):
    """Dense ranks of every rank's keys, each rank keeping its slice.
    Returns (pid_loc int32 [n_loc], [count, overflow] int64 [2])."""
    pid_full, count = sig.dense_rank_ints(_all_gather(key, group))
    stats = torch.stack([count.to(torch.int64), torch.zeros_like(
        count, dtype=torch.int64)])
    return pid_full[rank * n_loc:(rank + 1) * n_loc], stats


def _rank_bucketed(key, hi, group, rank: int, n_loc: int, d: int,
                   capacity: int):
    """Distributed dense ranking via hash-bucketed all-to-all.

    Returns (pid_loc int32 [n_loc], [count, overflow] int64 [2], both
    summed over the group).  Entries past a bucket's ``capacity`` are
    dropped and counted as overflow, as the reference's
    ``.at[].set(mode="drop")`` drops them.
    """
    dev = key.device
    bucket = hi % d
    sb, order = torch.sort(bucket, stable=True)  # jnp.argsort is stable
    # position of each element within its bucket
    # bucket sizes (torch.bincount's counts, at a static size of d: a
    # traced iteration then has no data-dependent shape)
    sizes = torch.zeros(d, dtype=torch.int64, device=dev).index_add_(
        0, sb, torch.ones_like(sb))
    start = torch.cumsum(sizes, 0) - sizes
    pos = torch.arange(n_loc, device=dev) - start[sb]
    overflow = (pos >= capacity).sum()
    # slot sb * capacity + pos; dropped entries write a spare last slot
    slot = torch.where(pos < capacity, sb * capacity + pos, d * capacity)
    send = torch.zeros(d * capacity + 1, dtype=torch.int64, device=dev)
    send[slot] = key[order]
    send_ok = torch.zeros(d * capacity + 1, dtype=torch.uint8, device=dev)
    send_ok[slot] = 1
    fkey = _all_to_all(send[:-1].view(d, capacity), group).reshape(-1)
    fok = _all_to_all(send_ok[:-1].view(d, capacity), group).reshape(-1)
    fok = fok.bool()
    # rank the valid entries in key order, invalid entries last
    r_order = torch.sort(fkey, stable=True).indices
    r_order = r_order[torch.sort(~fok[r_order], stable=True).indices]
    r_key, r_ok = fkey[r_order], fok[r_order]
    first = torch.ones_like(r_ok)
    first[1:] = r_key[1:] != r_key[:-1]
    new = first & r_ok
    local_rank = torch.cumsum(new, 0) - 1
    uniques = new.sum()
    # global offset of this rank's bucket
    all_uniques = _all_gather(uniques.view(1), group)
    offset = all_uniques[:rank].sum()
    granks = torch.empty(d * capacity, dtype=torch.int32, device=dev)
    granks[r_order] = torch.where(r_ok, offset + local_rank, 0).to(
        torch.int32)
    # route ranks back: the all-to-all restores the (origin, slot) layout
    back = _all_to_all(granks.view(d, capacity), group)
    pid_loc = torch.empty(n_loc, dtype=torch.int32, device=dev)
    pid_loc[order] = back[sb, torch.clamp(pos, max=capacity - 1)]
    stats = _all_reduce(torch.stack([uniques, overflow]), group)
    return pid_loc, stats


def iteration(pid_loc, shard: _Shard, group, *, rank: int, d: int,
              n_loc: int, n_pad: int, mode: str, ranking: str,
              capacity: int):
    """One iteration of Algorithm 1 on one rank, with no host read: the
    gathered pid column, the rank's new pids and [count, overflow] (int64
    [2], the same on every rank).  The dry-run traces this on fake
    tensors."""
    pid_full = _all_gather(pid_loc, group)
    hi, lo = _local_signatures(pid_full, shard, n_loc, n_pad, mode)
    key = sig.fuse_u32_pair(hi, lo)
    if ranking == "allgather":
        pid_loc, step = _rank_allgather(key, group, rank, n_loc)
    else:
        pid_loc, step = _rank_bucketed(key, hi, group, rank, n_loc, d,
                                       capacity)
    return pid_full, pid_loc, step


def _capacity(n_loc: int, d: int, capacity_factor: float) -> int:
    # One sender can route at most n_loc items to a single bucket, so
    # capacity=n_loc is always safe; the probabilistic bound (Chernoff on
    # hash balance) only pays off for large shards.
    if n_loc <= 4096:
        return n_loc
    return max(int(np.ceil(n_loc / d * capacity_factor)), 8)


def _rank_device(device) -> torch.device:
    """The rank's device: ``cuda:{local rank % cards}`` unless the caller
    names one (``cpu``, or a card by index); raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def build_bisim_distributed(
        graph: Graph, k: int, *, group=None, mode: str = "sorted",
        ranking: str = "allgather", early_stop: bool = True,
        capacity_factor: float = 4.0, sharded: Optional[ShardedGraph] = None,
        device=None) -> BisimResult:
    """Multi-rank Build_Bisim.  Semantics identical to build_bisim().

    Every rank of ``group`` (default: the WORLD group) calls it with the
    same arguments; each keeps only its own shard on its device and gets
    the whole `BisimResult` back.  ``device`` is ``cuda:{local rank %
    cards}`` unless the caller asks for ``cpu`` (or names a card); it
    raises without a card, and without an initialized process group
    (`repro_torch.launch.cluster.init_cluster` starts one).
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "build_bisim_distributed needs an initialized process group: "
            "call repro_torch.launch.cluster.init_cluster() (or "
            "torch.distributed.init_process_group) on every rank first")
    if mode not in sig.MODES:
        raise ValueError(f"unknown signature mode: {mode}")
    if ranking not in RANKINGS:
        raise ValueError(f"unknown ranking: {ranking}")
    dev = _rank_device(device)
    d = dist.get_world_size(group)
    rank = dist.get_rank(group)
    sg = sharded if sharded is not None else shard_graph(graph, d)
    if sg.num_devices != d:
        raise ValueError(f"the graph is sharded for {sg.num_devices} ranks, "
                         f"the group has {d}")
    n, n_loc = sg.num_nodes, sg.n_loc
    capacity = _capacity(n_loc, d, capacity_factor)
    shard = _local_shard(sg, rank, dev)

    pad_parts = 1 if sg.has_padding else 0
    counts = [sg.num_pid0 - pad_parts]
    stats = [IterationStats(0, counts[0], 0.0, 4 * n, 4 * n)]
    levels = []  # the gathered pid columns of levels 1..
    pid_loc = shard.pid0
    converged_at = None
    for j in range(1, k + 1):
        t0 = time.perf_counter()
        pid_full, pid_loc, step = iteration(
            pid_loc, shard, group, rank=rank, d=d, n_loc=n_loc,
            n_pad=sg.n_pad, mode=mode, ranking=ranking, capacity=capacity)
        if j > 1:
            levels.append(pid_full)
        count, overflow = step.tolist()  # the iteration's one host read
        if overflow > 0:
            raise RuntimeError(
                f"bucketed ranking overflow ({overflow} elements); "
                f"increase capacity_factor (> {capacity_factor})")
        dt = time.perf_counter() - t0
        c = count - pad_parts
        counts.append(c)
        stats.append(IterationStats(j, c, dt, 12 * sg.e_loc * d,
                                    8 * sg.n_pad))
        if early_stop and counts[-1] == counts[-2]:
            converged_at = j
            break
    if counts[1:]:
        levels.append(_all_gather(pid_loc, group))
    history = [sg.pid0[:n].copy()]
    if levels:
        history.extend(torch.stack(levels)[:, :n].cpu().numpy())
    return BisimResult(pids=np.stack(history), counts=counts, stats=stats,
                       converged_at=converged_at, k_requested=k)
