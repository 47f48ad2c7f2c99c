"""The f32 attention kernels' arithmetic, emulated on the CPU: 3xTF32.

The card's f32 kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, built on ``csrc/tf32x3.cuh``) compute
every product on the tensor cores in TF32: each f32 operand x is split
into big = tf32(x) and small = tf32(x - big), both rounded to nearest
with ties away from zero (add 0x1000 to the bits, drop the 13 low ones),
and a b is taken as a_small b_big + a_big b_small + a_big b_big, summed
into an f32 accumulator 8 terms (one m16n8k8 k-step) at a time.  Softmax,
masks, lse and delta stay in f32.

Here that arithmetic runs in plain PyTorch: the plain forward and the
backward rule of `repro_torch.kernels.flash_attention` with each product
emulated, at the f32 shapes of the card tests' ``FLASH_CASES`` (gemma2's
head_dim 256 with its window and softcap among them), held against a
float64 evaluation to the bars the card tests use: the output within
2e-5, lse within 1e-4 (of max(1, |lse|)), each gradient within 1e-4 of
its max |x|.  So the design's error budget is checked without a card.
One TF32 product alone misses the forward's bar: that is why there are
three.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.ref import attention_mask

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, by int32 bit operations on its f32 view."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """(big, small): the two TF32 parts of f32 ``x``."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b for f32 [..., m, k] and [..., k, n] as the kernels form it:
    per k-step of 8, the exact sum of the step's TF32 products (the
    product of two TF32 values is exact in f32) added to the f32
    accumulator and rounded (once a k-step here, where the card rounds
    after each of its three mma.sync).  terms=3: 3xTF32 (a_small b_big +
    a_big b_small + a_big b_big); terms=1: one TF32 product, big times
    big."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    k = a.shape[-1]
    if k % 8:  # the kernels' k-steps: zero columns past k
        pad = 8 - k % 8
        ab, asm = (torch.nn.functional.pad(x, (0, pad)) for x in (ab, asm))
        bb, bsm = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (bb, bsm))
    xs, ys = ((asm, ab, ab), (bb, bsm, bb)) if terms == 3 else ((ab,), (bb,))
    # [..., m, k / 8, terms * 8] and [..., k / 8, terms * 8, n]: a k-step's
    # terms side by side
    x = torch.stack([t.double().unflatten(-1, (-1, 8)) for t in xs], -2)
    x = x.flatten(-2).transpose(-2, -3)
    y = torch.stack([t.double().unflatten(-2, (-1, 8)) for t in ys], -3)
    y = y.flatten(-3, -2)
    c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for step in range(x.shape[-3]):
        c = (c + x[..., step, :, :] @ y[..., step, :, :]).float().double()
    return c.float()


def _grouped(t, hkv):
    b, h, s, d = t.shape
    return t.reshape(b, hkv, h // hkv, s, d)


def forward(q, k, v, mask, *, scale, softcap, terms=3):
    """(o, lse) of the plain forward with each product emulated (f32
    inputs) or exact (f64 inputs: the reference)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    exact = q.dtype == torch.float64
    prod = (lambda x, y: x @ y) if exact else (
        lambda x, y: mm(x, y, terms))
    qg = _grouped(q, hkv)
    s = prod(qg, k[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = prod(p, v[:, :, None]) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-37)),
                      -_NEG)[..., 0]
    return o.reshape(b, hq, sq, -1), lse.reshape(b, hq, sq)


def backward(q, k, v, o, lse, do, mask, *, scale, softcap):
    """(dq, dk, dv): the rule of `flash_attention_bwd_plain` with each of
    its five products (and the recomputed logits and dp) emulated for f32
    inputs, exact for f64 ones; dk and dv sum the group's q heads in the
    kernel's order (heads, then rows)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    exact = q.dtype == torch.float64
    prod = (lambda x, y: x @ y) if exact else mm
    qg, dog, og = (_grouped(t, hkv) for t in (q, do, o))
    delta = (dog * og).sum(-1)
    s_raw = prod(qg, k[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        t = torch.tanh(s_raw / softcap)
        s = softcap * t
    else:
        s = s_raw
    p = torch.where(mask, torch.exp(s - _grouped(lse[..., None], hkv)), 0.0)
    dp = prod(dog, v[:, :, None].transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = prod(ds, k[:, :, None])

    def over_heads(x):  # [b, hkv, g, sq, n] -> [b, hkv, g * sq, n]
        return x.reshape(b, hkv, g * sq, x.shape[-1])
    dk = prod(over_heads(ds).transpose(-1, -2), over_heads(qg))
    dv = prod(over_heads(p).transpose(-1, -2), over_heads(dog))
    return dq.reshape(b, hq, sq, d), dk, dv


# the f32 cases of the card tests' FLASH_CASES (b, hq, hkv, sq, skv, d,
# causal, window, softcap): causal and not, windows, softcaps, GQA groups
# 1, 2 and 8, ragged lengths, Sq = 1, gemma2-9b's head_dim 256 with its
# window and softcap
CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None),
    (1, 8, 1, 256, 256, 32, True, None, 30.0),
    (2, 2, 2, 128, 256, 64, True, 64, None),
    (1, 4, 4, 128, 128, 128, False, None, None),
    (1, 2, 2, 64, 64, 16, True, 32, 20.0),
    (1, 4, 2, 37, 37, 16, True, None, None),
    (1, 4, 2, 1, 300, 64, True, None, 50.0),
    (2, 4, 2, 37, 300, 64, True, 64, 50.0),
    (2, 16, 8, 300, 300, 256, True, 128, 50.0),
    (1, 4, 2, 200, 200, 112, True, None, None),
]


def _case(case, seed=0):
    """The case's f32 q, k, v, dO (N(0, 1), numpy seeded), its mask,
    scale and softcap."""
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    rng = np.random.default_rng(seed + sq + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d), (b, hq, sq, d)))
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device="cpu")
    return (q, k, v, do), mask, 1.0 / math.sqrt(d), softcap


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # just under the tie
    (3.0 * 2.0 ** -12, 3.0 * 2.0 ** -12),        # already TF32
    (0.0, 0.0),
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    assert float(tf32_rna(torch.tensor([x], dtype=torch.float32))) == want


def test_split_parts_sum_to_the_value():
    """big + small is within 2^-22 of x (one rounding of the small part,
    2^-11 of 2^-11), and big alone only within 2^-11."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(100_000, np.float32))
    big, small = split(x)
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -22
    assert float(((big.double() - x.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -11
    assert torch.equal(tf32_rna(big), big) and torch.equal(tf32_rna(small),
                                                           small)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_forward_within_f32_bars(case):
    """The plain forward, every product in 3xTF32, against float64: the
    output within the card's 2e-5 and lse within 1e-4."""
    (q, k, v, _), mask, scale, softcap = _case(case)
    o, lse = forward(q, k, v, mask, scale=scale, softcap=softcap)
    o64, lse64 = forward(q.double(), k.double(), v.double(), mask,
                         scale=scale, softcap=softcap)
    assert float((o.double() - o64).abs().max()) < 2e-5
    assert float((lse.double() - lse64).abs().max()) \
        <= 1e-4 * max(1.0, float(lse64.abs().max()))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_backward_within_f32_bars(case):
    """The backward rule, every product in 3xTF32 and fed the emulated
    forward's (o, lse), against float64 fed float64's: each gradient within
    1e-4 of its max |x|, as the card's backward tests hold the kernel."""
    (q, k, v, do), mask, scale, softcap = _case(case)
    kw = dict(scale=scale, softcap=softcap)
    o, lse = forward(q, k, v, mask, **kw)
    got = backward(q, k, v, o, lse, do, mask, **kw)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = forward(q64, k64, v64, mask, **kw)
    want = backward(q64, k64, v64, o64, lse64, do64, mask, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale_ = max(float(w.abs().max()), 1e-30)
        assert float((g.double() - w).abs().max()) <= 1e-4 * scale_, name


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[8]], ids=str)
def test_one_tf32_product_misses_the_forward_bar(case):
    """With one TF32 product (big times big) the forward's output lies
    ~1e-3 from float64, far past the 2e-5 bar that 3xTF32 keeps."""
    (q, k, v, _), mask, scale, softcap = _case(case)
    o64, _ = forward(q.double(), k.double(), v.double(), mask, scale=scale,
                     softcap=softcap)
    errs = {terms: float((forward(q, k, v, mask, scale=scale,
                                  softcap=softcap, terms=terms)[0].double()
                          - o64).abs().max()) for terms in (1, 3)}
    assert errs[3] < 2e-5 < 10 * 2e-5 < errs[1]


def test_emulation_matches_the_plain_version_layout():
    """The emulated forward and backward take the plain versions' layouts
    and masks: in float64 they are the plain versions."""
    (q, k, v, do), mask, scale, softcap = _case(CASES[7])
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    kw = dict(causal=True, window=64, softcap=50.0)
    o_plain, lse_plain = tfa.flash_attention_fwd_plain(q64, k64, v64, **kw)
    o, lse = forward(q64, k64, v64, mask, scale=scale, softcap=softcap)
    assert torch.allclose(o, o_plain, atol=1e-12)
    assert torch.allclose(lse, lse_plain, atol=1e-12)
    want = tfa.flash_attention_bwd_plain(q64, k64, v64, o_plain, lse_plain,
                                         do64, **kw)
    got = backward(q64, k64, v64, o, lse, do64, mask, scale=scale,
                   softcap=softcap)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-12)
