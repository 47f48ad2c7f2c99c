"""Per-device statistics of one step, counted as it runs (the port's
counterpart of `repro.launch.hlo_stats`, which walks XLA's
post-optimization HLO).

There is no HLO in eager PyTorch: `StepCounter`, a `TorchDispatchMode`,
sees every aten op of one step, on real tensors or fake ones (the
dry-run's `FakeTensorMode`, where nothing is allocated).  Above a DTensor
it returns ``NotImplemented``, so DTensor's dispatch unwraps the op to the
rank's local shards, and the counter then sees the local ops and the
collectives DTensor issues: the per-device view that SPMD-partitioned HLO
gives the reference.  (Counted above DTensor, as `FlopCounterMode` counts
it, a matmul shows its global FLOPs.)  The ops DTensor runs on global
shapes to propagate shardings (on tensors it makes with ``empty_strided``)
are left out.

  * flops — `torch.utils.flop_counter`'s formulas, and those the port's
    custom ops register (the attention kernels: 4·D and 10·D a visible
    pair), on each local op;
  * bytes — input plus output bytes of every other op on local tensors
    (views and metadata ops excluded).  Eager PyTorch has no fusion, so
    each elementwise op's round trip counts: more bytes than XLA's
    post-fusion walk, which counts a fusion's boundary once;
  * collective bytes — per kind, the byte-largest operand or result of
    each collective (a list operand, such as all_gather's outputs, counts
    whole), 2x for all-reduce, as the reference's multipliers: the
    ``c10d`` ops of `torch.distributed` calls and the functional
    collectives of DTensor's redistributions.  all-to-all counts what the
    rank sends, whatever a backend does to emulate it;
  * memory — the live bytes of the tracked inputs plus every op's new
    storages, each freed when its storage is: the peak is the step's
    high-water mark on one device.  (`torch.distributed._tools.
    mem_tracker.MemTracker` would also count the propagation's
    global-shape temporaries: a gemma2-9b logits chunk of 134 GB.)

All quantities are per device.  `HloStats` keeps the reference's fields.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

_COLL_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}
# name fragments of the c10d and functional collectives, by kind
_COLL_KINDS = (("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
               ("reduce_scatter", "reduce-scatter"),
               ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
               ("allgather", "all-gather"), ("all_gather", "all-gather"),
               ("send", "collective-permute"), ("recv", "collective-permute"))
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_FREE_OPS = ("empty", "empty_like", "empty_strided", "new_empty", "detach",
             "alias", "lift_fresh", "record_stream", "resize_", "set_",
             "wait_tensor")


@dataclasses.dataclass
class HloStats:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLL_MULT})
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLL_MULT})


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func):
    ns = func.namespace
    if ns not in _COLL_NAMESPACES:
        return None
    name = func._opname
    for frag, kind in _COLL_KINDS:
        if frag in name:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts the ops run inside it into ``stats`` (an `HloStats`), and
    tracks live device bytes (``live``, ``peak``)."""

    def __init__(self):
        super().__init__()
        self.stats = HloStats()
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self._propagation = WeakIdKeyDictionary()
        self._pending = False  # a DTensor op's propagation may follow

    # ------------------------------------------------------------- memory
    def track(self, *trees) -> int:
        """Count the storages of ``trees``' tensors (DTensors by their
        shards) as live; returns their bytes."""
        added = 0
        for t in _tensors(trees):
            added += self._add(_local(t))
        return added

    def _add(self, t: torch.Tensor) -> int:
        if t.device.type == "meta":
            return 0
        st = t.untyped_storage()
        if st in self._storages:
            return 0
        size = st.nbytes()
        self._storages[st] = weakref.ref(st, self._freer(size))
        self.live += size
        self.peak = max(self.peak, self.live)
        return size

    def _freer(self, size: int):
        def free(_):
            self.live -= size
        return free

    def storage_bytes(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        return total

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__torch_dispatch__", None) is not None
               and t is not torch.Tensor and not _is_fake_type(t)
               for t in types):
            # a tensor subclass (a DTensor): let it unwrap to local shards
            self._pending = True
            return NotImplemented
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func._opname
        if any(t in self._propagation for t in ins) or (
                self._pending and name == "empty_strided"):
            for t in outs:  # DTensor's sharding propagation: not counted
                self._propagation[t] = True
            return out
        self._pending = False
        self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        st = self.stats
        kind = _collective_kind(func)
        if kind is not None:
            sizes = [sum(_nbytes(t) for t in _tensors(a))
                     for a in list(args) + list(kwargs.values())]
            sizes += [_nbytes(t) for t in outs]
            if sizes and max(sizes):
                b = max(sizes) * _COLL_MULT[kind]
                st.collectives[kind] += b
                st.collective_bytes += b
                st.collective_counts[kind] += 1
                st.bytes += max(sizes)
        elif func.is_view or func._opname in _FREE_OPS:
            pass
        else:
            from torch.utils import flop_counter
            formula = flop_counter.flop_registry.get(func._overloadpacket)
            if formula is not None:
                st.flops += float(formula(*args, **kwargs, out_val=out))
            st.bytes += float(sum(_nbytes(t) for t in ins + outs))
        if not func.is_view:
            for t in outs:
                self._add(t)


def _is_fake_type(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return issubclass(t, FakeTensor)


def _local(t):
    from .mesh import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def count(fn, *args, track=()):
    """Run ``fn(*args)`` under a `StepCounter` that starts with the
    storages of ``args`` and ``track`` live; returns (result, counter)."""
    counter = StepCounter()
    counter.track(args, track)
    with counter:
        out = fn(*args)
    return out, counter
