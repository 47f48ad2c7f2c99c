"""Mamba2's SSD (state-space duality) mixer of the port (the port of
`repro.models.ssm`).

Train and prefill use the chunked SSD algorithm: an intra-chunk quadratic
term and the inter-chunk state, carried from chunk to chunk by a Python
loop where the reference runs `lax.scan`.  Decode is the O(1) recurrent
update h' = exp(dt·A)·h + dt·B⊗x.  The block also holds the depthwise
causal conv over (x, B, C), the per-head dt through softplus, the D skip
and the gated RMSNorm.

The reference computes all of this in plain `jnp`, with no Pallas
kernel, so the port is plain PyTorch.  The scan's state and every decay
are f32 (f64 for f64 activations: the CPU route's float64 evaluation);
the decode cache's ``h`` is f32 whatever the cache dtype, as
`repro.models.blocks.cache_struct` keeps it.  A decode step writes the new
``h`` and conv state into the cache in place.  Over a `launch.mesh` mesh
z and x keep ssm_inner's shards (whole heads) through the input
projection and the conv, and the scan runs on each rank's own rows and
heads (`_local_scan`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..launch import mesh as meshlib
from .layers import _acc, norm_spec, rms_norm
from .params import ParamSpec

shard = meshlib.shard


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def ssm_specs(cfg):
    d = cfg.d_model
    d_inner, nheads, n = ssm_dims(cfg)
    conv_dim = d_inner + 2 * n
    fused = 2 * d_inner + 2 * n + nheads  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, fused), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((nheads,), (None,), init="zeros"),
        "d_skip": ParamSpec((nheads,), (None,), init="ones"),
        "dt_bias": ParamSpec((nheads,), (None,), init="zeros"),
        "norm": norm_spec(d_inner),
        "out_proj": ParamSpec((d_inner, d), ("ssm_inner", "embed")),
    }


def _split(cfg, fused):
    """(z, x, B, C, dt) of the input projection's last dim."""
    d_inner, nheads, n = ssm_dims(cfg)
    return torch.split(fused, [d_inner, d_inner, n, n, nheads], dim=-1)


def _conv(p, u, state=None):
    """Depthwise causal conv (kernel k). u: [B, L, C].

    state: [B, k-1, C] previous inputs (decode); returns (y, new_state),
    new_state the last k-1 inputs (a tensor of its own, not a view that
    would keep the whole padded input alive in a prefill's cache).
    """
    w = meshlib.gather_weight(p["conv_w"]).to(u.dtype)
    k = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    y = sum(full[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    y = F.silu(y + meshlib.gather_weight(p["conv_b"]).to(u.dtype))
    return y, full[:, -(k - 1):, :].clone()


def ssd_chunked(xh, dt, a, b_, c_, *, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: [B, L, H, P]; dt: [B, L, H] (post-softplus); a: [H] (negative);
    b_/c_: [B, L, N]. Returns (y [B,L,H,P], h_final [B,H,N,P]), in the
    type of dt (f32, or f64 for f64 inputs).  A length that ``chunk`` does
    not divide is one chunk, as in the reference (every short prompt).
    """
    bsz, l, h, p = xh.shape
    n = b_.shape[-1]
    if l % chunk:
        chunk = l
    acc = dt.dtype
    da = dt * a  # [B, L, H] decay exponents (negative)
    xdt = (xh * dt[..., None]).to(acc)
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), dtype=acc, device=xh.device)
    idx = torch.arange(chunk, device=xh.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # causal, i >= j

    hprev, ys = h0, []
    for c0 in range(0, l, chunk):
        xb = xdt[:, c0:c0 + chunk]                          # [B, c, H, P]
        bb = b_[:, c0:c0 + chunk].to(acc)                   # [B, c, N]
        cb = c_[:, c0:c0 + chunk].to(acc)
        cum = torch.cumsum(da[:, c0:c0 + chunk], dim=1)     # [B, c, H]
        total = cum[:, -1]                                  # [B, H]
        # intra-chunk
        sim = torch.einsum("bin,bjn->bij", cb, bb)          # [B, c, c]
        # the exponents of future pairs (i < j) are positive: masked
        # before the exp (no inf in the forward) and after it (no NaN
        # gradient through the mask)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B, c, c, H]
        dec = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        # the reference's three-operand einsum in two steps, so that no
        # [B, c, c, H, P] intermediate is built
        y_intra = torch.einsum("bijh,bjhp->bihp", sim[..., None] * dec, xb)
        # inter-chunk (incoming state)
        cexp = cb[:, :, None, :] * torch.exp(cum)[..., None]  # [B, c, H, N]
        y_inter = torch.einsum("bchn,bhnp->bchp", cexp, hprev)
        # state update
        bexp = bb[:, :, None, :] \
            * torch.exp(total[:, None, :] - cum)[..., None]   # [B, c, H, N]
        hprev = torch.exp(total)[..., None, None] * hprev + torch.einsum(
            "bchn,bchp->bhnp", bexp, xb)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), hprev


def _local_scan(xh, dt, a, b_, c_, *, chunk: int):
    """`ssd_chunked`; on DTensors it runs on each rank's shards, and its
    outputs are wrapped back with xh's placements.

    A mesh dim that splits xh's batch splits every input's batch (a's
    gradient then comes back as a sum over it, ``Partial``); one that
    splits xh's heads into whole heads splits dt's and a's heads and
    leaves B and C whole (their gradients a sum over it).  Any other
    placement (a split sequence, uneven shards) is gathered first, as
    GSPMD reshards before a scan over the sequence.
    """
    if not meshlib.is_dtensor(xh):
        return ssd_chunked(xh, dt, a, b_, c_, chunk=chunk)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xh.device_mesh
    bsz, _, h, _ = xh.shape
    rep = Replicate()
    px, pa, ga, pb, gb, ph = ([] for _ in range(6))
    for i, pl in enumerate(xh.placements):
        n = mesh.size(i)
        if pl == Shard(0) and bsz % n == 0:
            for lst, v in ((px, pl), (pa, rep), (ga, Partial()), (pb, pl),
                           (gb, pl), (ph, Shard(0))):
                lst.append(v)
        elif pl == Shard(2) and h % n == 0:
            for lst, v in ((px, pl), (pa, Shard(0)), (ga, Shard(0)),
                           (pb, rep), (gb, Partial()), (ph, Shard(1))):
                lst.append(v)
        else:
            for lst in (px, pa, ga, pb, gb, ph):
                lst.append(rep)

    def local(t, want, grad):
        if not meshlib.is_dtensor(t):
            t = DTensor.from_local(t, mesh, [rep] * mesh.ndim)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local(grad_placements=grad)
    y, hfin = ssd_chunked(local(xh, px, px), local(dt, px, px),
                          local(a, pa, ga), local(b_, pb, gb),
                          local(c_, pb, gb), chunk=chunk)
    return (DTensor.from_local(y, mesh, px),
            DTensor.from_local(hfin, mesh, ph))


def _write(cache, new) -> None:
    """``cache[...] = new``, in place (a DTensor cache in its local shard,
    ``new`` first taking the cache's placements)."""
    if not meshlib.is_dtensor(cache):
        cache.copy_(new)
        return
    if not meshlib.is_dtensor(new):
        new = meshlib.distribute(new, cache.device_mesh, cache.placements)
    elif list(new.placements) != list(cache.placements):
        new = new.redistribute(cache.device_mesh, cache.placements)
    cache.to_local().copy_(new.to_local())


def apply_ssm(p, x, cfg, *, kind, cache=None, chunk: int = 256):
    """Mamba2 block. cache (decode): {'h': [B,H,N,P], 'conv': [B,k-1,C]},
    written in place and returned.  Returns (out, new_cache); train
    returns no cache."""
    bsz, l, _ = x.shape
    d_inner, nheads, n = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    acc = _acc(x.dtype)

    w = meshlib.gather_weight(p["in_proj"]).to(x.dtype)
    on_mesh = meshlib.is_dtensor(x)
    if on_mesh and x.numel() // x.shape[-1] > w.shape[0]:
        # on a mesh the shards of the fused columns do not fall on the
        # five parts' edges, so a split gathers what it splits: a long
        # prompt splits the weight (each part then its own product), a
        # decode step's few rows the product
        z, xbc_in, b_in, c_in, dt_raw = (
            x @ shard(wp, None, "ssm_inner") for wp in _split(cfg, w))
    else:
        z, xbc_in, b_in, c_in, dt_raw = _split(cfg, x @ w)
    # z and x keep ssm_inner's shards (whole heads); B and C are whole
    z = shard(z, "act_batch", "act_seq", "act_mlp")
    xbc_in = shard(xbc_in, "act_batch", "act_seq", "act_mlp")
    state = cache["conv"] if kind == "decode" else None
    if on_mesh:
        # x's conv apart from (B, C)'s, so that x keeps its shards
        xc, state_x = _conv(
            {"conv_w": p["conv_w"][:, :d_inner],
             "conv_b": p["conv_b"][:d_inner]},
            xbc_in, None if state is None else state[..., :d_inner])
        bc, state_bc = _conv(
            {"conv_w": p["conv_w"][:, d_inner:],
             "conv_b": p["conv_b"][d_inner:]},
            torch.cat([b_in, c_in], dim=-1),
            None if state is None else state[..., d_inner:])
        conv_state = torch.cat([state_x, state_bc], dim=-1)
        b_, c_ = bc[..., :n], bc[..., n:]
    else:
        conv_out, conv_state = _conv(
            p, torch.cat([xbc_in, b_in, c_in], dim=-1), state)
        xc = conv_out[..., :d_inner]
        b_ = conv_out[..., d_inner:d_inner + n]
        c_ = conv_out[..., d_inner + n:]

    dt = F.softplus(dt_raw.to(acc) + p["dt_bias"].to(acc))  # [B, L, H]
    a = -torch.exp(p["a_log"].to(acc))                       # [H]
    xh = xc.reshape(bsz, l, nheads, hd)

    if kind == "decode":
        hprev = cache["h"].to(acc)
        daexp = torch.exp(dt[:, 0] * a)                      # [B, H]
        h_new = daexp[..., None, None] * hprev + torch.einsum(
            "bn,bhp->bhnp", b_[:, 0].to(acc),
            xh[:, 0].to(acc) * dt[:, 0][..., None])
        y = torch.einsum("bn,bhnp->bhp", c_[:, 0].to(acc), h_new)
        y = y[:, None]                                       # [B, 1, H, P]
        _write(cache["h"], h_new.to(cache["h"].dtype))
        _write(cache["conv"], conv_state.to(cache["conv"].dtype))
        new_cache = {"h": cache["h"], "conv": cache["conv"]}
    elif kind in ("train", "prefill"):
        y, h_fin = _local_scan(xh, dt, a, b_, c_, chunk=chunk)
        new_cache = ({"h": h_fin, "conv": conv_state}
                     if kind == "prefill" else None)
    else:
        raise ValueError(f"kind must be train, prefill or decode, got "
                         f"{kind!r}")

    y = y + p["d_skip"].to(acc)[:, None] * xh.to(acc)
    y = y.reshape(bsz, l, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ meshlib.gather_weight(p["out_proj"]).to(x.dtype), new_cache
