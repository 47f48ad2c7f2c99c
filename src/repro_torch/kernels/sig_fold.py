"""The signature folds (Algorithm 1 lines 13-15) as hand-written Hopper
kernels, with their plain PyTorch versions.

`sig_fold` ports `repro.kernels.sig_fold._kernel` (reached through
`sig_fold` and `frontier_sig_fold`).  For each lane i of block
``i // edges_per_block``: hash (eLabel, pId) into two u32 lanes, mask by
``valid`` and, with ``dedup``, drop a lane whose (local_src, eLabel, pId)
triple equals the previous lane's in its block (bitonic-sorting the block
first unless ``presorted``); then wrap-add (mod 2^32) the surviving lanes
into row ``block * nodes_per_block + local_src``.  Lanes whose local_src
lies outside ``[0, nodes_per_block)`` fall out, as the reference's
broadcast compare drops them.

`chunk_sig_fold` ports `repro.kernels.sig_fold._chunk_kernel`, the
out-of-core build's per-chunk fold: dense ascending segment ids, the
host's cross-chunk ``keep0`` bit, adjacent-compare dedup, then the same
hash and wrap-add per segment.

Both kernels live in ``csrc/sig_fold.cu`` (built at first use by `_build`):
one C call zeroes the int64 output and folds into it, with a warp-level
segmented pre-reduction before the atomics.  On a CUDA tensor each wrapper
launches its kernel or raises; only a tensor on the CPU takes the plain
version.  Each returns an int64 [2, rows] tensor of u32 lanes, which
unpacks as (seg_hi, seg_lo).

`sig_fold` calls its kernel as the op ``repro_torch::sig_fold``
(`torch.library.Library`, CPU: the plain version, CUDA: the kernel),
whose fake implementation gives the output's shape: a fake tensor (the
dry-run's trace of a distributed iteration) goes through the real call
site and never reaches ctypes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.signatures import MASK32, hash_pair

# dynamic shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232_448
_LANE_BYTES = 12  # (local_src, eLabel, pId) per lane in the bitonic route
MAX_SORTED_EDGES_PER_BLOCK = 1 << ((_SMEM_LIMIT // _LANE_BYTES).bit_length() - 1)
THREADS = 256     # threads a CTA of the flat and chunk kernels
CTAS_PER_SM = 8   # grid cap: 8 CTAs of 256 threads fill an SM's 2048
VEC = 4           # lanes a thread loads at once where the columns allow


class LaunchPlan(NamedTuple):
    vec: int     # lanes a thread reads at once: VEC (int4 loads) or 1
    blocks: int  # CTAs of THREADS threads


def launch_plan(n: int, ptrs, sms: int) -> LaunchPlan:
    """How the flat and chunk kernels take ``n`` lanes whose columns
    (elabel, pid, seg int32; valid bool) start at the device addresses
    ``ptrs``, on a card of ``sms`` SMs.

    A thread reads VEC consecutive lanes with one 16-byte load a column
    when every int32 column is 16-byte aligned and the bool column 4-byte
    aligned (a row of an int32 [3, n] tensor is only when n % 4 == 0);
    otherwise one lane.  A warp takes 32 * vec lanes a step, and the grid
    strides over those tiles with at most ``sms * CTAS_PER_SM`` CTAs.
    """
    aligned = (all(p % 16 == 0 for p in ptrs[:3]) and ptrs[3] % VEC == 0)
    vec = VEC if aligned else 1
    tiles = -(-n // (32 * vec))
    blocks = max(1, min(-(-tiles // (THREADS // 32)), sms * CTAS_PER_SM))
    return LaunchPlan(vec, blocks)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """An entry point of the ``sig_fold`` library (built at first use)."""
    from ._build import load
    return getattr(load("sig_fold"), name)


def _call(entry: str, index: int, *args) -> None:
    """One C call of ``entry`` on card ``index`` and its current stream
    (the raw handle: no Stream object is built); raises if the card
    refuses."""
    err = _entry(entry)(*args, index,
                        torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error "
                           f"{err}")


def _launch(entry: str, cols, out, *sizes) -> None:
    """Zero ``out`` (int64 [2, rows]) and fold the lane columns ``cols``
    into it with the flat or chunk kernel, as `launch_plan` lays it out."""
    index = cols[0].device.index
    ptrs = [t.data_ptr() for t in cols]
    plan = launch_plan(cols[0].numel(), ptrs, _sms(index))
    _call(entry, index, *ptrs, out.data_ptr(), *sizes, plan.vec, plan.blocks)


_LANE_DTYPES = (torch.int32,) * 3 + (torch.bool,)


def _check_lanes(fn: str, names, cols) -> int:
    """Raise unless ``cols`` are 1-D int32, int32, int32 and bool tensors
    of one length on one device; return the length."""
    n = cols[0].numel()
    shape = (n,)
    for name, t, dt in zip(names, cols, _LANE_DTYPES):
        if t.dtype != dt or t.shape != shape:
            raise ValueError(f"{fn}: {name} must be a 1-D {dt} tensor of "
                             f"{n} lanes, got {t.dtype} {tuple(t.shape)}")
    dev = cols[0].device
    if any(t.device != dev for t in cols[1:]):
        raise ValueError(f"{fn}: all lanes must lie on one device")
    return n


def _check(elabel, pid_tgt, local_src, valid, nb: int, eb: int,
           dedup: bool, presorted: bool) -> int:
    n = _check_lanes("sig_fold", ("elabel", "pid_tgt", "local_src", "valid"),
                     (elabel, pid_tgt, local_src, valid))
    if not 0 < nb < 2 ** 31:
        raise ValueError(f"sig_fold: nodes_per_block={nb} must lie in "
                         "[1, 2^31)")
    if eb < 1 or n % eb:
        raise ValueError(f"sig_fold: {n} lanes are not a whole number of "
                         f"blocks of edges_per_block={eb}")
    if dedup and not presorted and eb & (eb - 1):
        raise ValueError("sig_fold: the in-kernel sort needs a power-of-two "
                         f"edges_per_block, got {eb}")
    return n


def sig_fold_plain(elabel, pid_tgt, local_src, valid, *,
                   nodes_per_block: int, edges_per_block: int,
                   dedup: bool = False, presorted: bool = False):
    """The fold in plain PyTorch ops: same arguments, same bits as the
    kernel.  Used by the CPU route and as the card's comparison."""
    nb, eb = nodes_per_block, edges_per_block
    n = _check(elabel, pid_tgt, local_src, valid, nb, eb, dedup, presorted)
    dev = elabel.device
    blk = torch.arange(n, device=dev) // eb
    s = torch.where(valid, local_src.to(torch.int64), nb)
    a, b = elabel.to(torch.int64), pid_tgt.to(torch.int64)
    keep = valid
    if dedup and presorted:
        first = torch.arange(n, device=dev) % eb == 0
        same = torch.zeros_like(first)
        same[1:] = (s[1:] == s[:-1]) & (a[1:] == a[:-1]) & (b[1:] == b[:-1])
        keep = valid & (first | ~same)
    keep = keep & (s >= 0) & (s < nb)
    rows = blk * nb + s
    if dedup and not presorted:
        # in-block sort + adjacent compare keeps one lane per distinct
        # (block, local_src, eLabel, pId)
        uniq = torch.unique(torch.stack([rows, a, b], 1)[keep], dim=0)
        rows, a, b = uniq[:, 0], uniq[:, 1], uniq[:, 2]
        keep = torch.ones_like(rows, dtype=torch.bool)
    hi, lo = hash_pair(a, b)
    rows = torch.where(keep, rows, 0)
    out = torch.zeros((2, (n // eb) * nb), dtype=torch.int64, device=dev)
    out[0].index_add_(0, rows, torch.where(keep, hi, 0))
    out[1].index_add_(0, rows, torch.where(keep, lo, 0))
    return out & MASK32


def _fold_on_card(elabel, pid_tgt, local_src, valid, nb: int, eb: int,
                  dedup: bool, presorted: bool):
    sort = dedup and not presorted
    if sort and eb * _LANE_BYTES > _SMEM_LIMIT:
        raise ValueError(
            f"sig_fold: edges_per_block={eb} needs {eb * _LANE_BYTES} B of "
            f"shared memory for the in-kernel sort; the limit is "
            f"{_SMEM_LIMIT} B (edges_per_block <= "
            f"{MAX_SORTED_EDGES_PER_BLOCK})")
    cols = (elabel, pid_tgt, local_src, valid)
    if not all(t.is_contiguous() for t in cols):
        raise ValueError("sig_fold: lanes must be contiguous")
    n = elabel.numel()
    out = torch.empty((2, (n // eb) * nb), dtype=torch.int64,
                      device=elabel.device)
    if out.numel():
        if sort:
            _call("sig_fold_bitonic", elabel.device.index,
                  *(t.data_ptr() for t in cols), out.data_ptr(), n // eb, eb,
                  nb)
        else:
            _launch("sig_fold_flat", cols, out, n, eb, nb, int(dedup))
        sig_fold.launches += 1
    return out


def _sig_fold_cpu(elabel, pid_tgt, local_src, valid, nodes_per_block,
                  edges_per_block, dedup, presorted):
    return sig_fold_plain(elabel, pid_tgt, local_src, valid,
                          nodes_per_block=nodes_per_block,
                          edges_per_block=edges_per_block, dedup=dedup,
                          presorted=presorted)


def _sig_fold_fake(elabel, pid_tgt, local_src, valid, nodes_per_block,
                   edges_per_block, dedup, presorted):
    rows = elabel.numel() // edges_per_block * nodes_per_block
    return elabel.new_empty((2, rows), dtype=torch.int64)


# the op: a schema and one kernel a dispatch key, with no autograd wrapper
# (the fold has no gradient), so a call costs the dispatcher's few
# microseconds on the host and no more
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("sig_fold(Tensor elabel, Tensor pid_tgt, Tensor local_src, "
            "Tensor valid, int nodes_per_block, int edges_per_block, "
            "bool dedup, bool presorted) -> Tensor")
_LIB.impl("sig_fold", _sig_fold_cpu, "CPU")
_LIB.impl("sig_fold", _fold_on_card, "CUDA")
torch.library.register_fake("repro_torch::sig_fold", _sig_fold_fake,
                            lib=_LIB)


def sig_fold(elabel, pid_tgt, local_src, valid, *, nodes_per_block: int,
             edges_per_block: int, dedup: bool = False,
             presorted: bool = False):
    """Blocked-CSR segmented signature fold.

    elabel/pid_tgt/local_src: int32 [num_blocks * edges_per_block];
    valid: bool (same shape); local_src is src minus the block's node base.
    Returns int64 [2, num_blocks * nodes_per_block]: the u32 lanes
    (seg_hi, seg_lo).

    ``dedup=True`` keeps one lane per (local_src, eLabel, pId) triple in
    each block: by adjacent compare when ``presorted`` promises the lanes
    arrive in triple order, after an in-kernel bitonic sort otherwise (a
    power-of-two ``edges_per_block`` that fits shared memory).
    """
    nb, eb = nodes_per_block, edges_per_block
    _check(elabel, pid_tgt, local_src, valid, nb, eb, dedup, presorted)
    if elabel.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sig_fold: no kernel for device {elabel.device}")
    return torch.ops.repro_torch.sig_fold(elabel, pid_tgt, local_src, valid,
                                          nb, eb, bool(dedup),
                                          bool(presorted))


sig_fold.launches = 0  # kernel launches made through the wrapper


def frontier_sig_fold(elabel, pid_tgt, seg, valid, *, num_sigs: int,
                      dedup: bool = False, presorted: bool = True):
    """One single-block `sig_fold` over a whole edge batch.

    ``seg`` plays local_src (entries >= num_sigs match no row) and the
    batch length is the edge budget; the kernel tiles the one block over
    the whole card.  The in-memory build folds every iteration through
    this form; an empty batch launches nothing.
    Returns int64 [2, num_sigs]: the u32 lanes (seg_hi, seg_lo).
    """
    n = elabel.numel()
    if n == 0:
        return torch.zeros((2, num_sigs), dtype=torch.int64,
                           device=elabel.device)
    return sig_fold(elabel, pid_tgt, seg.to(torch.int32), valid,
                    nodes_per_block=num_sigs, edges_per_block=n,
                    dedup=dedup, presorted=presorted)


def _check_chunk(elabel, pid_tgt, seg, valid, num_segments: int) -> int:
    n = _check_lanes("chunk_sig_fold", ("elabel", "pid_tgt", "seg", "valid"),
                     (elabel, pid_tgt, seg, valid))
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"chunk_sig_fold: num_segments={num_segments} "
                         "must lie in [0, 2^31)")
    return n


def chunk_sig_fold_plain(elabel, pid_tgt, seg, valid, keep0: bool, *,
                         num_segments: int, dedup: bool = True):
    """The chunk fold in plain PyTorch ops: same arguments, same bits as
    the kernel.  Used by the CPU route and as the card's comparison."""
    n = _check_chunk(elabel, pid_tgt, seg, valid, num_segments)
    dev = elabel.device
    s = seg.to(torch.int64)
    a, b = elabel.to(torch.int64), pid_tgt.to(torch.int64)
    keep = valid
    if dedup:
        differs = torch.ones(n, dtype=torch.bool, device=dev)
        differs[1:] = (s[1:] != s[:-1]) | (a[1:] != a[:-1]) | (b[1:] != b[:-1])
        differs[:1] = bool(keep0)
        keep = keep & differs
    keep = keep & (s >= 0) & (s < num_segments)
    hi, lo = hash_pair(a, b)
    rows = torch.where(keep, s, 0)
    out = torch.zeros((2, max(num_segments, 1)), dtype=torch.int64,
                      device=dev)
    out[0].index_add_(0, rows, torch.where(keep, hi, 0))
    out[1].index_add_(0, rows, torch.where(keep, lo, 0))
    return out[:, :num_segments] & MASK32


def chunk_sig_fold(elabel, pid_tgt, seg, valid, keep0: bool, *,
                   num_segments: int, dedup: bool = True):
    """Out-of-core per-chunk fold: dedup + hash + segment combine.

    One chunk of the (src, eLabel, pId)-sorted stream per call: ``seg``
    holds dense ascending local source ids, ``valid`` masks the tail
    padding and ``keep0`` is the host's cross-chunk boundary decision —
    False when the chunk's first triple equals the previous chunk's last
    (it applies only with ``dedup``).  Lanes with ``seg`` outside
    ``[0, num_segments)`` add nothing.

    elabel/pid_tgt/seg: int32 [E]; valid: bool [E]; keep0: a Python bool.
    Returns int64 [2, num_segments]: the u32 lanes (seg_hi, seg_lo).
    """
    dev = elabel.device
    if dev.type == "cpu":
        return chunk_sig_fold_plain(elabel, pid_tgt, seg, valid, keep0,
                                    num_segments=num_segments, dedup=dedup)
    n = _check_chunk(elabel, pid_tgt, seg, valid, num_segments)
    if dev.type != "cuda":
        raise ValueError(f"chunk_sig_fold: no kernel for device {dev}")
    cols = (elabel, pid_tgt, seg, valid)
    if not all(t.is_contiguous() for t in cols):
        raise ValueError("chunk_sig_fold: lanes must be contiguous")
    if n == 0:
        return torch.zeros((2, num_segments), dtype=torch.int64, device=dev)
    out = torch.empty((2, num_segments), dtype=torch.int64, device=dev)
    if num_segments:
        _launch("chunk_sig_fold", cols, out, n, num_segments, int(dedup),
                int(bool(keep0)))
        chunk_sig_fold.launches += 1
    return out


chunk_sig_fold.launches = 0  # kernel launches made through the wrapper
