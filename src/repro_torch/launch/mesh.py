"""Device mesh and logical-axis sharding rules over
`torch.distributed.device_mesh` (the port of `repro.launch.mesh`).

`make_production_mesh` is a function, so importing this module never
touches a process group.  A mesh spans the ranks of the default process
group (one rank a card), with named dims ``("data", "model")`` or
``("pod", "data", "model")``.

Logical names are resolved to mesh axes through a rule table; resolution
drops (a) axes absent from the active mesh (so single-pod and multi-pod use
one rule set), (b) axes already consumed by an earlier dim of the same spec,
and (c) axes that do not divide the dim size (40 heads over a 16-way model
axis stay unsharded rather than padded).

`resolve_spec` gives, per tensor dim, the tuple of mesh axes that split it
(the reference's ``PartitionSpec``); `placements_for` turns that into
DTensor placements, one per mesh dim.  Drop rule (b) is what keeps a mesh
axis from splitting two tensor dims, which a placement list could not say.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A `DeviceMesh` of ``shape`` with dims named ``axes`` over the
    default process group's ranks (``prod(shape)`` of them), on cards
    (``cuda``) or the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh: 16x16 ``(data, model)``, or
    2x16x16 ``(pod, data, model)``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod=multi_pod),
                     device_type=device_type)


# Weight axes ('embed' is the FSDP dim), then activation axes.
DEFAULT_RULES = {
    "embed": ("data",),
    "mlp": ("model",),
    "qkv": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    # experts are sharded over 'data' (EP axis of the a2a dispatch; the
    # 'model' axis column/row-shards each expert's matrices via 'mlp')
    "experts": ("data",),
    "q_lora": ("model",),
    "ssm_inner": ("model",),
    "layers": (),
    "act_batch": ("pod", "data"),
    "act_seq": (),
    # residual-stream activations are model-sharded (Megatron-SP style)
    "act_embed": ("model",),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_kv_seq": ("model",),
    "act_vocab": ("model",),
    "act_exp": ("model",),
    "act_cap": ("pod", "data"),
    "act_tokens": ("pod", "data"),
    "act_frames": (),
}

# Per-shape overrides.
SHAPE_RULE_OVERRIDES = {
    "train_4k": {},
    "prefill_32k": {},
    "decode_32k": {},
    # batch=1: data-parallel axes carry the sequence instead (context/SP);
    # the kv cache seq axis spreads over the whole mesh.
    "long_500k": {"act_batch": (), "act_seq": ("pod", "data"),
                  "act_cap": (), "act_tokens": (),
                  "act_kv_seq": ("pod", "data", "model")},
}


def rules_for_shape(shape_name: Optional[str]) -> dict:
    rules = dict(DEFAULT_RULES)
    rules.update(SHAPE_RULE_OVERRIDES.get(shape_name or "", {}))
    return rules


class _Context:
    """The active (mesh, rules).  Process-wide, not thread-local: the
    autograd engine runs a card's backward (and the remat's recompute in
    it) on its own device thread, which must see the step's context."""
    state = None


_ctx = _Context()


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` and ``rules`` the active ones for `shard`.  Inside,
    plain tensors that meet DTensors (positions, masks, the padded-vocab
    bias) count as replicated (DTensor's ``implicit_replication``);
    DTensor's own collectives do the communication."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules or DEFAULT_RULES)
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.state = prev


def active_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of any object whose
    ``shape`` is already that dict (the JAX mesh's form)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(axes, shape, mesh, rules) -> tuple:
    """Logical axes tuple -> per tensor dim, the tuple of mesh axes that
    split it (``()`` for none), with the drop rules above."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, name in zip(shape, axes):
        if name is None:
            out.append(())
            continue
        proposed = rules.get(name, ())
        if isinstance(proposed, str):
            proposed = (proposed,)
        picked = []
        prod = 1
        for ax in proposed:
            if ax not in sizes or ax in used:
                continue
            if dim % (prod * sizes[ax]) != 0:
                continue
            picked.append(ax)
            prod *= sizes[ax]
        used.update(picked)
        out.append(tuple(picked))
    return tuple(out)


def placements_for(spec, mesh) -> tuple:
    """DTensor placements of a resolved spec, one per mesh dim: ``Shard(d)``
    where tensor dim d takes that mesh axis, else ``Replicate()``.  A dim
    split by two axes gets two ``Shard(d)`` in mesh order (the first the
    major split), as the JAX mesh splits ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"mesh axes {axes} of dim {d} are not in the "
                             f"mesh's order {tuple(names)}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def sharding_for(axes, shape, mesh, rules) -> tuple:
    """The placements of a tensor of ``shape`` with logical ``axes``."""
    return placements_for(resolve_spec(axes, shape, mesh, rules), mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_map_axes(fn, axes_tree, *rest):
    """Map ``fn`` over the axes tuples of a nested-dict tree, with
    matching ``rest`` trees alongside."""
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *(r[k] for r in rest))
                for k in sorted(axes_tree)}
    if not _is_axes(axes_tree):
        raise ValueError(f"not a logical axes tuple: {axes_tree!r}")
    return fn(axes_tree, *rest)


def tree_shardings(axes_tree, shape_tree, mesh, rules):
    """Parallel (axes, tensor or shape) trees -> a tree of placements."""
    return tree_map_axes(
        lambda ax, t: sharding_for(ax, tuple(getattr(t, "shape", t)), mesh,
                                   rules), axes_tree, shape_tree)


def distribute(t: torch.Tensor, mesh, placements):
    """``t`` (every rank's same full tensor) as a DTensor: each rank keeps
    its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def distribute_tree(tree, axes_tree, mesh, rules):
    """A tree of full tensors as DTensors placed by their logical axes
    (`tree_shardings`)."""
    return tree_map_axes(lambda _, t, pl: distribute(t, mesh, pl), axes_tree,
                         tree, tree_shardings(axes_tree, tree, mesh, rules))


def shard(x, *axes):
    """Apply a logical sharding constraint (a no-op outside a context, and
    on a plain tensor).

    Inside a context a DTensor is redistributed to the resolved placements.
    In eager PyTorch that is a real collective where one is needed (a
    ``Partial`` sum reduce-scattered to a ``Shard``, a gather to
    ``Replicate``), run at this point; GSPMD took the same call as a hint
    that its partitioner was free to place."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} vs shape {tuple(x.shape)}")
    want = sharding_for(axes, x.shape, x.device_mesh, st[1])
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def split_last(x, heads: int, head_dim: int):
    """``x`` [..., heads * head_dim] viewed as [..., heads, head_dim].  A
    DTensor whose last dim a mesh axis splits into pieces that are not
    whole heads (8 kv heads over a 16-way axis) is gathered on that axis
    first, as GSPMD reshards before such a reshape."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(x.ndim - 1)
        want = [Replicate() if p == last and heads % x.device_mesh.size(i)
                else p for i, p in enumerate(x.placements)]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def merge_last(x, heads: int, head_dim: int):
    """``x`` [..., heads, head_dim] viewed as [..., heads * head_dim]: the
    inverse of `split_last`.  On a DTensor whose heads no mesh axis splits
    (they were gathered because the axis does not divide them, as 56 or
    40 heads over 16), the merge is made on the local tensor and its
    gradient is first brought back to ``x``'s placements: the row-parallel
    projection's gradient splits the merged dim into pieces that are not
    whole heads, which no view takes back."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Shard
        n = x.ndim
        if not any(p in (Shard(n - 1), Shard(n - 2)) for p in x.placements):
            local = x.to_local()
            return DTensor.from_local(
                local.reshape(*local.shape[:-2], heads * head_dim),
                x.device_mesh, x.placements)
    return x.reshape(*x.shape[:-2], heads * head_dim)


def gather_weight(w):
    """A DTensor weight gathered over the mesh axes of its FSDP dim (the
    axes the rules give ``embed``), its tensor-parallel shards kept: the
    FSDP all-gather at use, whose backward reduce-scatters the gradient.
    Outside a context, or on a plain tensor, ``w`` as it is."""
    st = getattr(_ctx, "state", None)
    if st is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    fsdp = st[1].get("embed", ())
    fsdp = (fsdp,) if isinstance(fsdp, str) else fsdp
    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in fsdp else p
            for i, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def gather_dim(x, dim: int):
    """A DTensor with tensor dim ``dim`` whole on every rank (its
    ``Shard(dim)`` placements gathered); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if p == Shard(dim) else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_offset(dim: int, size: int, mesh, placements) -> int:
    """This rank's first index along tensor dim ``dim`` (of global
    ``size``, split evenly by every ``Shard(dim)`` in mesh order, the
    first the major split)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    off, chunk = 0, size
    for i, p in enumerate(placements):
        if p == Shard(dim):
            chunk //= mesh.size(i)
            off += coord[i] * chunk
    return off


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1
