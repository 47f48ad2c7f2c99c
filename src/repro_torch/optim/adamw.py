"""AdamW + grad clipping + warmup-cosine schedule (the port of
`repro.optim.adamw`).

The reference's update is pure: every leaf gets about six f32 temporaries
of its size.  Beside 12 bytes of state a parameter (bf16 weight and
gradient, f32 m and v) that does not fit on one card at gemma2-9b's
917,504,000-entry embedding (about 22 GB at once), so here the update runs
leaf by leaf, in place, over slices of at most `SLICE` entries, with the
reference's operations in the reference's order.  The schedule and the
bias corrections are host scalars in f32, as the reference computes them;
the global norm stays on the device.

Under a device mesh the leaves are DTensors, pinned to their weights'
placements (`train.trainer.make_train_step`): the update runs on each
rank's local shard (``to_local()``, elementwise, so no collective), and
the global norm sums the local squares and all-reduces once over the
mesh, a replicated leaf counted once.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..launch.mesh import is_dtensor
from ..models.params import tree_leaves, tree_map

SLICE = 1 << 26  # entries a slice of the in-place update (256 MB in f32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_opt_state(params):
    """Zero f32 m and v beside each parameter (with its placements under a
    mesh), and the step (a host int32 scalar)."""
    def f32(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format,
                                requires_grad=False)
    return {"m": tree_map(f32, params), "v": tree_map(f32, params),
            "step": torch.zeros((), dtype=torch.int32)}


def schedule_lr(cfg: OptConfig, step) -> float:
    """Linear warmup to ``lr``, then cosine to ``min_lr_ratio * lr``, in f32
    as the reference computes it."""
    f = np.float32
    step = f(int(step))
    warm = np.minimum(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * f(0.5) * (
        f(1) + np.cos(f(np.pi) * t))
    return float(f(cfg.lr) * warm * cos)


def _local(t):
    """A leaf's local tensor: a DTensor's shard, a tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def _slices(t, *, inplace: bool = True):
    """``t``'s local entries in slices of `SLICE`: views of it, or (for a
    leaf only read, such as a gradient after a redistribution) of a flat
    copy where the shard is not contiguous."""
    t = _local(t)
    return (t.view(-1) if inplace else t.reshape(-1)).split(SLICE)


def _copies(t) -> int:
    """How many ranks of a DTensor's mesh hold each of its entries: the
    product of its replicated mesh dims (1 for a tensor)."""
    if not is_dtensor(t):
        return 1
    from torch.distributed.tensor import Replicate
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements)
                     if isinstance(p, Replicate))


def global_norm(tree):
    """sqrt of the sum of every leaf's sum of squares, in f32, on the
    leaves' device (a 0-d tensor).  DTensor leaves add their local squares
    (a replicated leaf's divided by its copies) and one all-reduce over
    the mesh sums them."""
    total, mesh = 0, None
    for g in tree_leaves(tree):
        sq = sum(s.float().square().sum()
                 for s in _slices(g, inplace=False))
        if is_dtensor(g):
            mesh, sq = g.device_mesh, sq / _copies(g)
        total = total + sq
    if mesh is not None:
        import torch.distributed as dist
        if mesh.size() != dist.get_world_size():
            raise ValueError("global_norm: the mesh must span the process "
                             "group's ranks")
        dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``state``'s m and v;
    returns (params, state, metrics) as the reference does."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    f = np.float32
    bc1 = float(f(1) - f(b1) ** f(step))
    bc2 = float(f(1) - f(b2) ** f(step))
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (params, grads, state["m"], state["v"]))):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g, inplace=False),
                                  _slices(m), _slices(v)):
            u = gs.float() * scale                     # g
            ms.mul_(b1).add_(u, alpha=1 - b1)          # m_new
            vs.mul_(b2).add_(u.square_(), alpha=1 - b2)  # v_new
            u = torch.div(vs, bc2).sqrt_().add_(cfg.eps)
            delta = torch.div(ms, bc1).div_(u)         # mhat / (sqrt + eps)
            pf = ps.float()
            delta.add_(pf, alpha=cfg.weight_decay)
            ps.copy_(pf - lr * delta)
    new_state = {"m": state["m"], "v": state["v"],
                 "step": torch.tensor(step, dtype=torch.int32)}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
