"""Mixture-of-experts block of the port (the port of `repro.models.moe`): a
top-k router and capacity-based dispatch to the routed experts, beside the
shared ones.

Two dispatch routes, chosen as the reference chooses (`apply_moe`):

* `_apply_moe_a2a` (a `launch.mesh` mesh with ``data`` and ``model`` axes
  whose sizes divide the experts, d_ff, d_model and each rank's tokens),
  on each rank's local shards: an all-to-all over the ``model`` sub-group
  gives each model rank a disjoint subset of its tokens at full d_model;
  they are routed and capacity-dispatched locally and sent over the
  ``data`` sub-group to the ranks that own their experts; the expert
  products run against the full-F weights (gathered over ``model`` at
  use, as the MLP's weights are gathered); the outputs, gate-weighted on
  the owner, come back over ``data``, are combined and go back over
  ``model``.  The all-to-alls are c10d calls with an autograd rule of
  their own (an all-to-all of equal blocks is its own transpose);
* `_apply_moe_dense` (one device, and a mesh the a2a does not divide):
  the sort-based capacity scheme: the (token, expert) assignments sorted
  by expert id, positioned within capacity windows and scattered into
  [experts, capacity, d_model].

Assignments past an expert's capacity are dropped in both routes: they
land in a row past the buffer, which is sliced off.  Where the reference
relies on an order the port keeps it: the sort by expert id is stable (as
``jnp.argsort``), so the same assignments are dropped; ties in the
router's top-k go to the lower expert id (as ``lax.top_k``); and each
token's k contributions are summed in a fixed order, with no atomics, so
a token's output is the same on every run.  The router runs in f32 (f64
for f64 activations: the CPU route's float64 evaluation), the expert
products in the activations' dtype through `torch.bmm`: plain large
products, which the reference leaves to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..launch import mesh as meshlib
from . import layers
from .params import ParamSpec

# the (token, expert) assignments dropped for capacity: a caller that
# wants the count sets this to a zero int64 tensor on the activations'
# device, and each dispatch adds its drops to it there (no host sync)
dropped = None


def moe_specs(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {"router": ParamSpec((d, e), (None, None)),  # small; replicated
         "w_gate": ParamSpec((e, d, f), ("experts", None, "mlp")),
         "w_up": ParamSpec((e, d, f), ("experts", None, "mlp")),
         "w_down": ParamSpec((e, f, d), ("experts", "mlp", None))}
    if cfg.num_shared_experts:
        s["shared"] = layers.mlp_specs(cfg, d_ff=f * cfg.num_shared_experts)
    return s


def capacity_for(num_tokens: int, cfg) -> int:
    """Slots an expert of the dense route: its fair share of the
    assignments times ``capacity_factor``, rounded up to 128."""
    c = math.ceil(num_tokens * cfg.moe_top_k * cfg.capacity_factor
                  / cfg.num_experts)
    return max(-(-c // 128) * 128, 128)


def apply_moe(p, x, cfg):
    """MoE block, x: [B, S, D] -> [B, S, D].  The all-to-all dispatch when
    the active mesh has ``data`` and ``model`` axes, the experts divide
    over ``data``, d_ff and d_model over ``model``, and each rank's tokens
    over ``model``; the dense dispatch otherwise (one device, tests)."""
    mesh = meshlib.active_mesh()
    if mesh is not None:
        sizes = meshlib.axis_sizes(mesh)
        if "data" in sizes and "model" in sizes:
            nd, tp = sizes["data"], sizes["model"]
            npod = sizes.get("pod", 1)
            b, s_len, d = x.shape
            t_loc = (b // (nd * npod)) * s_len if b % (nd * npod) == 0 \
                else 0
            if (cfg.num_experts % nd == 0 and cfg.d_ff % tp == 0
                    and d % tp == 0 and t_loc > 0 and t_loc % tp == 0):
                return _apply_moe_a2a(p, x, cfg, mesh)
    return _apply_moe_dense(p, x, cfg)


# --------------------------------------------------------------- pieces
def _route(tokens, router, k: int):
    """(gate [T, k], expert ids [T, k]): the top k of the router's softmax,
    ties to the lower id (a stable descending sort, as ``lax.top_k``),
    gates renormalised over the k."""
    acc = torch.promote_types(tokens.dtype, torch.float32)
    probs = torch.softmax(tokens.to(acc) @ router.to(acc), dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :k], eidx[:, :k]
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _local_dispatch_indices(eidx, gate, e: int, cap_send: int, nd: int):
    """Per-rank routing tables. eidx/gate: [t_loc, k].

    Returns, for the assignments in expert order (slot [t_loc*k] into an
    [nd, e_loc*cap_send] send buffer, the slot past it for a dropped one;
    their tokens, gates and whether each is kept).  With ``nd`` = 1 the
    slots are the dense route's, expert * cap + position."""
    t_loc, k = eidx.shape
    e_loc = e // nd
    dev = eidx.device
    flat_e = eidx.reshape(-1)
    tok = torch.arange(t_loc, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t_loc * k, device=dev) - start[se]
    keep = pos < cap_send
    owner = se // e_loc                       # data rank that owns expert
    within = (se % e_loc) * cap_send + pos    # slot on the owner
    slot = torch.where(keep, owner * (e_loc * cap_send) + within,
                       nd * e_loc * cap_send)
    return slot, tok[order], gate.reshape(-1)[order], keep


def _count_drops(keep) -> None:
    if dropped is not None:
        dropped.add_((~keep).sum())


def _scatter_rows(rows, slot, n: int):
    """An [n, ...] buffer of zeros with ``rows[i]`` at row ``slot[i]``; the
    dropped rows' slot n lies past it."""
    buf = rows.new_zeros((n + 1,) + tuple(rows.shape[1:]))
    return buf.index_put((slot,), rows)[:n]


def _combine(rows, slot, tok, weight, t: int, k: int):
    """[t, d]: each token's k contributions ``rows[slot] * weight`` (a
    dropped one, whose weight is 0, reads the last row as the reference
    does), summed in a fixed order: grouped by token with a stable sort,
    then a sum over k."""
    contrib = rows[slot.clamp(max=rows.shape[0] - 1)] * weight.to(
        rows.dtype)[:, None]
    by_token = torch.sort(tok, stable=True).indices
    return contrib[by_token].view(t, k, rows.shape[1]).sum(1)


def _experts(disp, w_gate, w_up, w_down):
    """SwiGLU of each expert over its slots: disp [E, C, D] -> [E, C, D]."""
    dt = disp.dtype
    h = F.silu(torch.bmm(disp, w_gate.to(dt))) * torch.bmm(disp, w_up.to(dt))
    return torch.bmm(h, w_down.to(dt))


# ---------------------------------------------------------------- dense
def _apply_moe_dense(p, x, cfg):
    """x: [B, S, D] -> [B, S, D]."""
    y = _dense_routed(p, x, cfg)
    if cfg.num_shared_experts:
        y = y + layers.apply_mlp(p["shared"], x)
    return y


def _dense_routed(p, x, cfg):
    if meshlib.is_dtensor(x):
        # a mesh the a2a does not divide: every rank computes the whole
        # block on whole tensors (so every gradient is the same on every
        # rank, and replicated), and keeps its share of the result
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        whole = {name: w.full_tensor() if meshlib.is_dtensor(w) else w
                 for name, w in p.items() if name != "shared"}
        y = DTensor.from_local(_dense_routed(whole, x.full_tensor(), cfg),
                               mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        return meshlib.shard(y, "act_batch", "act_seq", "act_embed")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    cap = capacity_for(t, cfg)
    tokens = x.reshape(t, d)
    gate, eidx = _route(tokens, p["router"], k)
    slot, tok, gates, keep = _local_dispatch_indices(eidx, gate, e, cap, 1)
    _count_drops(keep)
    disp = _scatter_rows(tokens[tok], slot, e * cap).view(e, cap, d)
    out = _experts(disp, p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(out.reshape(e * cap, d), slot, tok, gates * keep, t, k)
    return y.view(b, s, d)


# ------------------------------------------------------------ all-to-all
def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """Block i of the rows goes to rank i of ``group``; block i of the
    result came from rank i (equal blocks).  Its own transpose, so the
    gradient goes back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _placements(mesh, **dims):
    """``Shard(dims[name])`` on the mesh dims named in ``dims``, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[n]) if n in dims else Replicate()
            for n in mesh.mesh_dim_names]


def _local(t, mesh, placements, grad_placements=None):
    """This rank's block of ``t`` (a DTensor, or a plain tensor that every
    rank holds whole) in ``placements``.  ``grad_placements`` say how the
    block's gradient is to be read (default: as the block itself;
    ``Partial`` where ranks that hold the same block use it on different
    tokens)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not meshlib.is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def _apply_moe_a2a(p, x, cfg, mesh):
    """The token-split all-to-all dispatch (the module's docstring) over
    ``mesh``'s ``data`` and ``model`` sub-groups; experts split over
    ``data``, replicated over ``pod``."""
    from torch.distributed.tensor import DTensor, Partial
    sizes = meshlib.axis_sizes(mesh)
    b, s_len, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    nd, tp = sizes["data"], sizes["model"]
    b_loc = b // (nd * sizes.get("pod", 1))
    t_loc = b_loc * s_len
    t_m = t_loc // tp                 # tokens routed per model rank
    e_loc = e // nd
    cap = max(-(-int(t_m * k * cfg.capacity_factor / e) // 64) * 64, 64)
    model_g, data_g = mesh.get_group("model"), mesh.get_group("data")

    x_pl = _placements(mesh, pod=0, data=0, model=2)
    x_loc = _local(x, mesh, x_pl)                      # [b_loc, S, D/tp]
    # the router and the full-F expert weights serve other tokens on every
    # rank that holds them: their gradients are partial sums there
    router = _local(p["router"], mesh, _placements(mesh),
                    [Partial()] * mesh.ndim)
    w_pl = _placements(mesh, data=0)
    w_grad = [q if n == "data" else Partial()
              for n, q in zip(mesh.mesh_dim_names, w_pl)]
    w_g, w_u, w_dn = (_local(p[n], mesh, w_pl, w_grad)
                      for n in ("w_gate", "w_up", "w_down"))

    # 1. [t_loc, D/tp] -> this model rank's t_m tokens at full d_model
    recv = _AllToAll.apply(x_loc.reshape(t_loc, d // tp), model_g)
    tokens = recv.view(tp, t_m, d // tp).transpose(0, 1).reshape(t_m, d)
    # 2. route and dispatch to the experts' owners over 'data'
    gate, eidx = _route(tokens, router, k)
    slot, tok, gates, keep = _local_dispatch_indices(eidx, gate, e, cap,
                                                     nd)
    _count_drops(keep)
    nslots = nd * e_loc * cap
    send = _scatter_rows(tokens[tok], slot, nslots)
    send_g = _scatter_rows(gates * keep, slot, nslots)
    recv = _AllToAll.apply(send, data_g).view(nd, e_loc, cap, d)
    recv_g = _AllToAll.apply(send_g, data_g).view(nd, e_loc, cap)
    disp = recv.transpose(0, 1).reshape(e_loc, nd * cap, d)
    # 3. expert products at full F, gate-weighted on the owner
    out = _experts(disp, w_g, w_u, w_dn)
    out = out * recv_g.transpose(0, 1).reshape(e_loc, nd * cap, 1).to(
        out.dtype)
    # 4. back over 'data', combined in f32, back over 'model'
    back = out.view(e_loc, nd, cap, d).transpose(0, 1).reshape(nslots, d)
    mine = _AllToAll.apply(back, data_g)
    y = _combine(mine.float(), slot, tok, keep, t_m, k).to(x_loc.dtype)
    y = _AllToAll.apply(y.view(t_m, tp, d // tp).transpose(0, 1), model_g)
    y = DTensor.from_local(y.reshape(b_loc, s_len, d // tp), mesh, x_pl,
                           run_check=False)
    if cfg.num_shared_experts:
        y = y + layers.apply_mlp(p["shared"], x)
    return y
