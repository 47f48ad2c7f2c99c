"""Device-resident maintenance propagation (paper §4 on the card).

The port of `repro.core.device_maint`.  `BisimMaintainer._propagate`
recomputes frontier signatures and resolves them against the per-level
store S.  The host path does both in numpy (`hashes_np` + `SigStore`);
this module is the device path the maintainer takes with
``device_propagation=True``:

  * `frontier_fold` — uploads a gathered frontier batch and folds it into
    signature hash lanes through `signatures.frontier_signature_hashes`:
    the Hopper `sig_fold` kernel on a CUDA tensor, its plain version on a
    CPU tensor.  Under set semantics the batch is sorted on its device
    and the kernel drops adjacent duplicates (the reference's
    ``use_kernel`` route); multiset mode folds every lane.  A
    per-frontier cache keeps the batch's device constants (pId_0, labels,
    seg, bounds) resident across levels, for both routes: only
    pId_{j-1}(tgt) moves a level.

  * `DeviceSigStore` — a device mirror of the array-backed `SigStore`:
    one sorted int64 key column and an int32 pid column, padded to a
    power-of-two capacity with the all-ones sentinel.  `probe_mint_insert`
    is the fused resolve: binary-search probe, first-occurrence pid
    minting and merge-insert; the mint and the merge run only when a
    probe missed.  The staged path (`_probe_step` -> `_resolve_step` ->
    `_merge_step`) is kept as its bit-parity reference.  Pids equal
    `SigStore.get_or_assign`'s key for key; `to_host` re-materializes the
    host store only when the store is extracted.

  * `resident_level_resolve` / `resident_levels_resolve` — one
    propagation level (fold + probe + mint + changed mask), and every
    level at once while nothing changes (the fused k-loop); the pid
    deltas cross back only for a level where something changed.

Keys.  The reference keeps two u32 lanes; torch has no u32 search and no
u64, so a signature is one int64 key ``((hi << 32) | lo) ^ (1 << 63)``
(`signatures.fuse_u32_pair`): its signed order is the unsigned (hi, lo)
order, and the all-ones key is ``INT64_MAX``, the sentinel.  A genuine
all-ones key therefore shares its value with the padding, and the
reference's two defences stay: miss-before-masked in `_mint_plan`,
real-before-sentinel in `_merge_step`.

Syncs.  The reference gates the mint behind a `lax.cond` inside one
program.  Eager PyTorch branches on the host, so every resolve reads one
miss count (a host sync) before it decides; the steady state of a level
reads that count with its changed count in one transfer, and the fused
k-loop reads all levels' counts in one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import signatures as sig
from .sig_store import SigStore, keys_to_lanes, lanes_to_keys
from ..obs import tracer as obs

_I32_MAX = np.iinfo(np.int32).max
_SENT = torch.iinfo(torch.int64).max  # the all-ones (hi, lo) key

# Default bucket floor: store capacities below this share one bucket.
BUCKET_FLOOR = 8


def bucket(n: int, floor: "int | None" = None) -> int:
    """Smallest power of two >= max(n, floor): a store's capacity.

    ``floor`` (default `BUCKET_FLOOR`) must be a power of two.  For
    n >= floor the padding waste is strictly under 2x.  The reference
    buckets shapes to bound XLA recompiles; the port pads only the store
    columns, whose sentinel lanes never change a resolved pid.
    """
    if floor is None:
        floor = BUCKET_FLOOR
    if floor < 1 or (floor & (floor - 1)):
        raise ValueError(f"bucket floor must be a power of two, got {floor}")
    b = floor
    while b < n:
        b <<= 1
    return b


def _check_pid_space(next_pid: int, minted: int) -> None:
    if next_pid + minted > _I32_MAX:
        raise OverflowError("device store pid space exceeded int32; rebuild "
                            "to re-densify pids")


# ---------------------------------------------------------------- the fold
class _Batch(NamedTuple):
    """A frontier batch's device constants: what stays put across levels."""
    p0: torch.Tensor      # int32 [num_sigs]  pId_0 of each frontier node
    lab: torch.Tensor     # int32 [e]         edge labels
    seg: torch.Tensor     # int32 [e]         frontier position of each edge
    bounds: torch.Tensor  # int64 [num_sigs + 1]
    e: int


def _as_i32(x) -> np.ndarray:
    """A host column as int32 lanes (u32 values keep their bits)."""
    return np.asarray(x).astype(np.int64, copy=False).astype(np.int32)


def _prepare_batch(pid0_vals, seg, elabel, num_sigs: int, *, bounds,
                   device) -> _Batch:
    """Upload a frontier batch's constants.  The gathers emit edges in
    (sorted) frontier order; a caller passing ``bounds`` asserts that
    grouping itself, otherwise one host searchsorted recovers them."""
    seg = np.asarray(seg).astype(np.int64, copy=False)
    e = int(seg.shape[0])
    if bounds is None:
        if e and (np.diff(seg) < 0).any():
            raise ValueError("frontier_fold requires ascending seg ids")
        bounds = np.searchsorted(seg, np.arange(num_sigs + 1))
    cols = (_as_i32(pid0_vals), _as_i32(elabel), _as_i32(seg))
    p0, lab, seg_d = (torch.from_numpy(c).to(device) for c in cols)
    bounds = torch.from_numpy(np.asarray(bounds, dtype=np.int64)).to(device)
    return _Batch(p0, lab, seg_d, bounds, e)


def _cached_batch(cache, cache_key, pid0_vals, seg, elabel, num_sigs: int,
                  *, bounds, device) -> _Batch:
    """`_prepare_batch`, kept in ``cache`` for the frontier ``cache_key``
    (the caller drops the cache on every graph or pId_0 mutation)."""
    e = int(np.asarray(elabel).shape[0])
    if (cache is not None and cache_key is not None
            and cache.get("key") is not None and cache["e"] == e
            and np.array_equal(cache["key"], cache_key)):
        return cache["batch"]
    batch = _prepare_batch(pid0_vals, seg, elabel, num_sigs, bounds=bounds,
                           device=device)
    if cache is not None and cache_key is not None:
        cache.update(key=np.asarray(cache_key).copy(), e=e, batch=batch)
    return batch


def _fold(batch: _Batch, tgt: torch.Tensor, *, dedup: bool):
    """The fold of one level: (hi, lo) u32 lanes in int64 [num_sigs]."""
    num_sigs = batch.p0.numel()
    if dedup:
        return sig.frontier_signature_hashes(
            batch.p0, batch.seg, batch.lab, tgt, batch.e, num_sigs=num_sigs,
            dedup=True)
    return sig.frontier_signature_hashes_presorted(
        batch.p0, batch.lab, tgt, batch.bounds, batch.e, num_sigs=num_sigs)


def _upload(col, device) -> torch.Tensor:
    return torch.from_numpy(_as_i32(col)).to(device)


def _lanes(x, device) -> torch.Tensor:
    """u32 lanes, a tensor or a host array, as a tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def frontier_fold(pid0_vals, seg, elabel, pid_tgt, num_sigs: int, *,
                  device, dedup: bool = True, bounds=None,
                  cache: "dict | None" = None, cache_key=None):
    """Fold a gathered frontier batch into signature hash lanes on
    ``device``.

    Same contract as `hashes_np.signatures_from_edges`, and bit-identical
    to it (``seg`` ascending, as the gathers produce), but returns
    *device* tensors: (hi, lo), u32 lanes in int64 [num_sigs], which feed
    `DeviceSigStore.get_or_assign_pairs` without a host round-trip.

    ``bounds`` optionally passes the [num_sigs + 1] segment boundaries
    when the gather already knows them (CSR offsets).  ``cache`` with
    ``cache_key`` (an array identifying the frontier) keeps the batch's
    device constants between calls: propagation folds the same frontier
    at every level while only pId_{j-1} changes.
    """
    batch = _cached_batch(cache, cache_key, pid0_vals, seg, elabel, num_sigs,
                          bounds=bounds, device=device)
    obs.event("maint.dispatch", what="frontier_fold", edges=batch.e)
    return _fold(batch, _upload(pid_tgt, device), dedup=dedup)


# ------------------------------------------------------ probe, mint, merge
def _probe_core(key, kpid, q, count: int, size: int):
    """Binary search + gather.  Returns (valid, found, out) with out the
    stored pid where found, -1 elsewhere."""
    cap = key.numel()
    valid = torch.arange(q.numel(), device=q.device) < count
    idx = torch.searchsorted(key, q)  # 'left' insertion positions
    idxc = idx.clamp(max=cap - 1)
    found = (key[idxc] == q) & (idx < size) & valid
    out = torch.where(found, kpid[idxc], torch.full_like(kpid[idxc], -1))
    return valid, found, out


class _MintPlan(NamedTuple):
    sk: torch.Tensor        # probe keys in group order (masked: sentinel)
    minted: torch.Tensor    # int32 pid each sorted lane would mint
    is_first: torch.Tensor  # bool: the lane mints its key's pid
    n_novel: torch.Tensor   # 0-dim: novel keys


def _mint_plan(q, valid, found, out, next_pid: int):
    """First-occurrence pid assignment for the missing probe keys.

    Mirrors `SigStore.get_or_assign` exactly: found keys keep their
    stored pid; novel keys mint ``next_pid + rank``, rank being the order
    of first occurrence in the probe batch.  Returns (out, plan), the
    plan being everything the merge needs.
    """
    p = q.numel()
    miss = valid & ~found
    # group the missing keys (masked lanes carry the sentinel and sort
    # after them); miss-before-masked, then position, break ties, so each
    # group's head is the key's first occurrence even for a genuine
    # all-ones key that shares the sentinel's value with masked lanes.
    # Stable sorts, least significant key first.
    mk = torch.where(miss, q, torch.full_like(q, _SENT))
    order = torch.sort((~miss).to(torch.uint8), stable=True).indices
    order = order[torch.sort(mk[order], stable=True).indices]
    sk, smiss = mk[order], miss[order]
    head = torch.ones_like(smiss)
    head[1:] = sk[1:] != sk[:-1]
    is_first = head & smiss
    gid = torch.cumsum(head, 0) - 1
    # appearance rank of a novel head = novel heads at earlier probe
    # positions (the host store's double argsort of `first`): a running
    # count over positions, read back at each head
    first_at = torch.zeros(p, dtype=torch.int64, device=q.device)
    first_at[order] = is_first.to(torch.int64)
    rank = torch.cumsum(first_at, 0) - 1
    head_rank = torch.where(is_first, rank[order], 0)
    app = torch.zeros(p, dtype=torch.int64, device=q.device).scatter_reduce_(
        0, gid, head_rank, "amax")  # values >= 0, so the zeros add nothing
    minted = (next_pid + app[gid]).to(torch.int32)
    out = out.clone()
    out[order] = torch.where(smiss, minted, out[order])
    return out, _MintPlan(sk, minted, is_first, is_first.sum())


def _probe_step(key, kpid, q, count: int, size: int):
    """Probe only (staged reference path): returns (out, n_miss)."""
    valid, found, out = _probe_core(key, kpid, q, count, size)
    return out, (valid & ~found).sum()


def _resolve_step(key, kpid, q, count: int, size: int, next_pid: int):
    """Probe + mint plan (staged reference path): returns (out, plan)."""
    valid, found, out = _probe_core(key, kpid, q, count, size)
    return _mint_plan(q, valid, found, out, next_pid)


def _pad_columns(key, kpid, new_cap: int):
    """Grow the sorted columns to ``new_cap`` without touching content."""
    extra = new_cap - key.numel()
    if extra <= 0:
        return key, kpid
    return (torch.cat([key, torch.full((extra,), _SENT, dtype=key.dtype,
                                       device=key.device)]),
            torch.cat([kpid, torch.zeros(extra, dtype=kpid.dtype,
                                         device=kpid.device)]))


def _merge_step(key, kpid, plan: _MintPlan, size: int, *, new_cap: int):
    """Merge the minted novel keys into the sorted columns, re-bucketed
    to ``new_cap``."""
    cap = key.numel()
    ck = torch.cat([key, torch.where(plan.is_first, plan.sk,
                                     torch.full_like(plan.sk, _SENT))])
    cp = torch.cat([kpid, torch.where(plan.is_first, plan.minted,
                                      torch.zeros_like(plan.minted))])
    # real-before-sentinel tiebreak: a genuine all-ones key must beat the
    # padding sentinels, or its pid would be sliced away below
    pad = torch.cat([torch.arange(cap, device=key.device) >= size,
                     ~plan.is_first]).to(torch.uint8)
    order = torch.sort(pad, stable=True).indices
    order = order[torch.sort(ck[order], stable=True).indices]
    ck, cp = ck[order][:new_cap], cp[order][:new_cap]
    return _pad_columns(ck, cp, new_cap)


def _probe_mint_insert(key, kpid, q, count: int, size: int, next_pid: int,
                       *, new_cap: int):
    """The fused resolve: probe, then, only if a probe missed, mint plan
    and merge-insert.  Returns (out, n_novel, new_key, new_kpid); the
    columns are right in both branches (padded to ``new_cap``)."""
    valid, found, out = _probe_core(key, kpid, q, count, size)
    obs.event("maint.sync", what="miss_count", keys=count)
    if not int((valid & ~found).sum()):
        return (out, 0) + _pad_columns(key, kpid, new_cap)
    out, plan = _mint_plan(q, valid, found, out, next_pid)
    return (out, int(plan.n_novel)) + _merge_step(key, kpid, plan, size,
                                                  new_cap=new_cap)


# ------------------------------------------------------- resident levels
class _LevelProbe(NamedTuple):
    """One level's fold and probe, before any mint."""
    q: torch.Tensor
    valid: torch.Tensor
    found: torch.Tensor
    out: torch.Tensor
    old: torch.Tensor
    n_miss: torch.Tensor     # 0-dim
    n_changed: torch.Tensor  # 0-dim, of the probe's pids (exact if no miss)


def _level_resident_step(batch: _Batch, tgt, dstore, old, *,
                         dedup: bool) -> _LevelProbe:
    """One maintenance level without a host sync: fold, probe against
    the level's store, and the changed-vs-old mask of the probed pids."""
    hi, lo = _fold(batch, tgt, dedup=dedup)
    q = sig.fuse_u32_pair(hi, lo)
    count = q.numel()
    valid, found, out = _probe_core(dstore.key, dstore.kpid, q, count,
                                    dstore.size)
    return _LevelProbe(q, valid, found, out, old, (valid & ~found).sum(),
                       (valid & (out != old)).sum())


def _level_finish(lp: _LevelProbe, dstore, next_pid: int, n_miss: int,
                  n_changed: int):
    """Mint and merge a probed level if it missed; returns (pids int64 |
    None, changed bool | None, n_changed, next_pid')."""
    out = lp.out
    if n_miss:
        out, plan = _mint_plan(lp.q, lp.valid, lp.found, out, next_pid)
        obs.event("maint.sync", what="level_scalars", keys=lp.q.numel())
        n_novel, n_changed = torch.stack(
            [plan.n_novel, (lp.valid & (out != lp.old)).sum()]).tolist()
        _check_pid_space(next_pid, n_novel)
        new_size = dstore.size + n_novel
        obs.event("maint.dispatch", what="merge_insert", minted=n_novel)
        dstore.key, dstore.kpid = _merge_step(
            dstore.key, dstore.kpid, plan, dstore.size,
            new_cap=bucket(new_size))
        dstore.size = new_size
        dstore._host = None
        next_pid += n_novel
    if n_changed == 0:
        return None, None, 0, next_pid
    obs.event("maint.sync", what="level_deltas", changed=n_changed)
    changed = lp.valid & (out != lp.old)
    return (out.cpu().numpy().astype(np.int64), changed.cpu().numpy(),
            n_changed, next_pid)


def _old_pids(olds, device) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(olds).astype(np.int32, copy=False)).to(device)


def resident_level_resolve(dstore, pid0_vals, seg, elabel, pid_tgt,
                           num_sigs: int, old_pid, next_pid: int, *,
                           dedup: bool = True, bounds=None,
                           cache: "dict | None" = None, cache_key=None):
    """Fold + resolve + changed-mask for one propagation level.

    Bit-identical to `frontier_fold` + `SigStore.get_or_assign` + the
    host ``old != new`` comparison.  Returns

        (pids int64 [num_sigs] | None, changed bool [num_sigs] | None,
         n_changed, next_pid')

    where the arrays are None iff n_changed == 0.  The steady state (no
    miss) reads two scalars, in one transfer.
    """
    dev = dstore.device
    batch = _cached_batch(cache, cache_key, pid0_vals, seg, elabel, num_sigs,
                          bounds=bounds, device=dev)
    obs.event("maint.dispatch", what="level_resident", keys=num_sigs)
    lp = _level_resident_step(batch, _upload(pid_tgt, dev), dstore,
                              _old_pids(old_pid, dev), dedup=dedup)
    obs.event("maint.sync", what="level_scalars", keys=num_sigs)
    n_miss, n_changed = torch.stack([lp.n_miss, lp.n_changed]).tolist()
    return _level_finish(lp, dstore, next_pid, n_miss, n_changed)


def resident_levels_resolve(dstores, pid0_vals, seg, elabel, tgts,
                            num_sigs: int, olds, next_pids, *,
                            dedup: bool = True, bounds=None,
                            cache: "dict | None" = None, cache_key=None):
    """Resolve ALL propagation levels while nothing changes (the fused
    k-loop).

    ``dstores``/``tgts``/``olds``/``next_pids`` are per level (level j =
    index j-1): ``tgts[j]`` is pId_j(tgt) of the frontier's out-edge
    targets, ``olds[j]`` the frontier's current pId_{j+1} column.  Every
    level's fold and probe is dispatched with the targets' pids as they
    stand before the call, which stays valid only while earlier levels
    change nothing; one transfer then reads every level's counts.

    Returns ``(nclean, dirty, next_pid_d)``: the number of leading levels
    confirmed unchanged; None when every level is clean, else the
    resident-result triple ``(pj, changed, n_changed)`` of level
    ``nclean + 1``, whose store merge has been applied; and that level's
    next_pid (None when dirty is None).  Later levels must be recomputed
    by the caller.
    """
    dev = dstores[0].device
    batch = _cached_batch(cache, cache_key, pid0_vals, seg, elabel, num_sigs,
                          bounds=bounds, device=dev)
    k = len(tgts)
    obs.event("maint.dispatch", what="levels_resident", keys=num_sigs,
              levels=k)
    probes = [_level_resident_step(batch, _upload(tgts[j], dev), dstores[j],
                                   _old_pids(olds[j], dev), dedup=dedup)
              for j in range(k)]
    # THE steady-state sync: every level's two counts in one transfer
    obs.event("maint.sync", what="levels_scalars", keys=num_sigs, levels=k)
    counts = torch.stack([torch.stack([lp.n_miss, lp.n_changed])
                          for lp in probes]).tolist()
    dirty = [j for j, (m, c) in enumerate(counts) if m or c]
    if not dirty:
        return k, None, None
    d = dirty[0]
    out, changed, n_changed, next_pid_d = _level_finish(
        probes[d], dstores[d], int(next_pids[d]), *counts[d])
    return d, (out, changed, n_changed), next_pid_d


# -------------------------------------------------------------- the store
class DeviceSigStore:
    """Device mirror of one level's `SigStore`: the sorted int64 key
    column and the int32 pid column live on ``device``, padded to a
    power-of-two capacity with the all-ones sentinel; probe and
    merge-insert run there.

    The mirror is authoritative once created: every resolve goes through
    it, and `to_host` re-materializes the host `SigStore` lazily (cached
    until the next insert).
    """

    __slots__ = ("key", "kpid", "size", "device", "_host")

    def __init__(self, host: SigStore, device):
        keys = np.asarray(host.keys)
        pids = np.asarray(host.pids)
        if pids.size and int(pids.max()) > _I32_MAX:
            raise OverflowError(
                "device store mirrors pids as int32; rebuild to re-densify")
        self.device = torch.device(device)
        self.size = int(keys.shape[0])
        cap = bucket(self.size)
        key = np.full(cap, _SENT, np.int64)
        kpid = np.zeros(cap, np.int32)
        key[:self.size] = keys_to_lanes(keys)
        kpid[:self.size] = pids
        self.key = torch.from_numpy(key).to(self.device)
        self.kpid = torch.from_numpy(kpid).to(self.device)
        # no reference to ``host``: its owner may keep resolving into it
        self._host = None

    def __len__(self) -> int:
        return self.size

    @property
    def nbytes(self) -> int:
        """Device bytes of the two columns (capacity, padding included)."""
        return (self.key.numel() * self.key.element_size()
                + self.kpid.numel() * self.kpid.element_size())

    # ------------------------------------------------------------- resolve
    def probe_mint_insert(self, qhi, qlo, count: int,
                          next_pid: int) -> tuple[np.ndarray, int]:
        """The fused resolve: probe + mint + merge-insert, with one host
        sync on the miss count and one transfer of the resolved pids.

        ``qhi``/``qlo`` are u32 lanes (device tensors straight out of
        `frontier_fold`, or host arrays) of which the first ``count`` are
        real probes.  Returns (pids int64 [count], next_pid'),
        bit-identical to `SigStore.get_or_assign` on the fused keys and
        to the staged path.
        """
        _check_pid_space(next_pid, count)
        q = sig.fuse_u32_pair(_lanes(qhi, self.device),
                              _lanes(qlo, self.device))
        cap = self.key.numel()
        new_cap = cap if self.size + count <= cap \
            else bucket(self.size + count)
        with obs.span("store.resolve_device", keys=count, fused=True) as sp:
            obs.event("maint.dispatch", what="probe_mint_insert",
                      keys=count)
            out, n, self.key, self.kpid = _probe_mint_insert(
                self.key, self.kpid, q, count, self.size, next_pid,
                new_cap=new_cap)
            obs.event("maint.sync", what="probe_mint_insert", keys=count)
            out_h = out[:count].cpu().numpy().astype(np.int64)
            sp.set(minted=n)
            if n:
                self.size += n
                self._host = None  # mirrored back lazily on extraction
        return out_h, next_pid + n

    def get_or_assign_pairs(self, qhi, qlo, count: int,
                            next_pid: int) -> tuple[np.ndarray, int]:
        """Bulk get-or-assign over (hi, lo) probe lanes — the fused
        `probe_mint_insert` under its historical name."""
        return self.probe_mint_insert(qhi, qlo, count, next_pid)

    def get_or_assign_keys(self, keys, next_pid: int) -> tuple[np.ndarray,
                                                               int]:
        """Host-key entry point (fused u64 keys, e.g. level-0 label keys)."""
        keys = np.asarray(keys, dtype=np.uint64)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        return self.get_or_assign_pairs(hi, keys.astype(np.uint32),
                                        int(keys.shape[0]), next_pid)

    # ------------------------------------------------------------ mirroring
    def to_host(self) -> SigStore:
        """The mirrored store on the host: sorted u64 keys + int64 pids,
        the exact `SigStore` the host path would hold."""
        if self._host is None:
            self._host = SigStore(
                lanes_to_keys(self.key[:self.size].cpu().numpy()),
                self.kpid[:self.size].cpu().numpy().astype(np.int64),
                presorted=True)
        return self._host
