"""Parameter specification trees of the port: one source of truth for
shapes, logical sharding axes and initializers (the port of
`repro.models.params`).

A model builds a nested dict of `ParamSpec`; from it come:
  * materialized parameters (`init_params`) — for real runs and tests;
  * meta tensors (`param_shapes`) — for the dry-run (no allocation);
  * logical-axis trees (`param_axes`) — mapped to DTensor placements by
    `repro_torch.launch.mesh`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: Optional[tuple] = None  # logical axis name (or None) per dim;
    #                               None: no axis on any dim
    init: str = "normal"     # 'normal' | 'zeros' | 'ones'
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in length")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (keys in sorted order,
    as `jax.tree` orders them), with matching ``rest`` trees alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_params(specs, generator: torch.Generator, dtype=torch.float32,
                place=None):
    """Materialize parameters on the generator's device, leaf by leaf in
    sorted-key order.  ``place(tensor, spec)``, if given, turns each leaf
    into what the tree keeps (a sharded run: this rank's shard) as soon as
    it is drawn, so only one full leaf is alive at a time.  The distributions are the JAX package's: ones,
    zeros, or normal x scale with scale = 1/sqrt(fan_in), fan_in the first
    dim (for a stacked [G, ...] weight that is G, as in the reference).
    The bits differ from `jax.random`'s; tests convert the JAX package's
    parameters with `params_from_jax` instead."""
    dev = generator.device

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
        return torch.randn(spec.shape, generator=generator, dtype=dtype,
                           device=dev).mul_(scale)
    if place is None:
        return tree_map(make, specs)
    return tree_map(lambda spec: place(make(spec), spec), specs)


def params_from_jax(tree, *, dtype=None, device=None):
    """The JAX package's parameter tree, as numpy arrays, as the port's
    parameters: same keys, same orientation (``x @ w`` with w as
    [d_in, d_out], groups stacked [G, ...]), so the copy goes name to
    name.  On the card unless ``device="cpu"`` is asked (`resolve_device`:
    with no card and no such request it raises)."""
    device = resolve_device(device)

    def convert(a):
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or t.dtype)
    return tree_map(convert, tree)


def param_shapes(specs, dtype=torch.bfloat16):
    """Meta tensors of the specs' shapes in ``dtype`` (no storage): the
    port's ``jax.ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs)


def param_axes(specs):
    return tree_map(lambda s: s.axes, specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in tree_leaves(specs)))
