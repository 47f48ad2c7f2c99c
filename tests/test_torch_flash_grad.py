"""The port's flash attention gradient (`repro_torch.models.flash_xla`:
a `torch.autograd.Function` whose CPU route is the plain port of the
reference's ``_fwd_impl`` and ``_bwd_rule``) against the JAX package's
custom VJP (`repro.models.flash_xla`), on the same numpy inputs.

The bar is the reference's own gradient test's, rtol = atol = 2e-4
(`tests/test_models.py::test_flash_xla_grads_match_reference`); the lse is
`_fwd_impl`'s.  The kernels behind the card's route are held to these
plain versions in `tests/test_torch_kernels_gpu.py` (marked ``gpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as ref_layers
from repro.models.flash_xla import _fwd_impl, flash_attention_xla

torch = pytest.importorskip("torch")
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import flash_xla  # noqa: E402
from repro_torch.models.flash_xla import attend_flash  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)

# b, h, hkv, sq, skv, d, causal, window, softcap, q_offset, chunk: causal
# on and off, window, softcap, GQA groups 1, 2 and 4, right-aligned and
# shifted queries, rows that see no key (q_offset < 0 under a window)
CASES = [
    (1, 2, 2, 32, 32, 16, False, None, None, 0, 8),
    (1, 4, 2, 32, 32, 16, True, None, None, 0, 8),
    (2, 4, 4, 32, 32, 16, True, 8, None, 0, 16),
    (1, 4, 2, 48, 48, 32, True, None, 30.0, 0, 16),
    (1, 4, 2, 24, 40, 16, True, 8, 20.0, 16, 8),
    (1, 4, 1, 32, 32, 16, True, None, None, 5, 32),
    (1, 2, 1, 32, 32, 16, True, 4, 50.0, -6, 8),
    (2, 4, 2, 64, 64, 16, False, 16, 25.0, 3, 64),
]


def _inputs(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32) for sh in
            ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, h, d))]


def _port_grads(q, k, v, w, **kw):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = attend_flash(*ts, **kw)
    (torch.tanh(o) * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def test_grads_match_reference_case():
    """The reference's own case: the port's gradients against
    ``jax.grad`` of the reference's ``attend_flash`` and of its full
    (materialized) attention."""
    q, k, v, _ = _inputs(3, 2, 4, 2, 64, 64, 16)
    kw = dict(causal=True, window=16, softcap=25.0)
    qpos = jnp.arange(64)

    def ref_full(q, k, v):
        o = ref_layers.attend_full(q, k, v, qpos=qpos, kpos=qpos, **kw)
        return jnp.sum(jnp.tanh(o))

    def ref_flash(q, k, v):
        return jnp.sum(jnp.tanh(flash_attention_xla(
            q, k, v, True, 16, 25.0, 0, 16)))

    want_full = jax.grad(ref_full, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(ref_flash, argnums=(0, 1, 2))(q, k, v)
    _, got = _port_grads(q, k, v, np.ones_like(q), chunk=16, **kw)
    for g, w, wf in zip(got, want, want_full):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
        np.testing.assert_allclose(g, np.asarray(wf), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_fwd_bwd_match_reference(case):
    b, h, hkv, sq, skv, d, causal, window, softcap, off, chunk = case
    q, k, v, w = _inputs(sum(case[:6]), b, h, hkv, sq, skv, d)

    def ref(q, k, v):
        o = flash_attention_xla(q, k, v, causal, window, softcap, off, chunk)
        return jnp.sum(jnp.tanh(o) * w), o

    (_, want_o), want = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    o, got = _port_grads(q, k, v, w, causal=causal, window=window,
                         softcap=softcap, q_offset=off, chunk=chunk)
    np.testing.assert_allclose(o, np.asarray(want_o), **TOL)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if off < 0:  # rows with no key: output 0, no gradient
        assert not np.abs(o[:, :-off]).any()
        assert not np.abs(got[0][:, :-off]).any()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_matches_reference(case):
    """`flash_attention_fwd_plain` (and so the CPU route of
    ``return_lse``) gives `_fwd_impl`'s (o, lse), +BIG rows included."""
    b, h, hkv, sq, skv, d, causal, window, softcap, off, chunk = case
    q, k, v, _ = _inputs(sum(case[:6]), b, h, hkv, sq, skv, d)
    want_o, want_lse = _fwd_impl(q, k, v, causal, window, softcap, off,
                                 chunk)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o, lse = tfa.flash_attention_fwd_plain(*heads, chunk=chunk, **kw)
    want_lse = np.asarray(want_lse).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    assert np.array_equal(lse.numpy() == tfa.BIG, want_lse == tfa.BIG)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want_o),
                               **TOL)
    o2, lse2 = tfa.flash_attention(*heads, return_lse=True, **kw)
    np.testing.assert_allclose(lse2.numpy(), want_lse, **TOL)


def test_cpu_route_is_the_plain_version(monkeypatch):
    """On CPU tensors the Function runs the plain forward and backward
    (once each), and no kernel wrapper counts a launch."""
    calls = []
    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain"):
        fn = getattr(flash_xla, name)
        monkeypatch.setattr(flash_xla, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    q, k, v, w = _inputs(0, 1, 2, 1, 16, 16, 16)
    _port_grads(q, k, v, w, causal=True, window=None, softcap=None)
    assert calls == ["flash_attention_fwd_plain", "flash_attention_bwd_plain"]
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == before


def test_train_kind_matches_reference_layer():
    """`apply_gqa(kind="train")` routes through `attend_flash`: the output
    and its input gradient equal the reference's, and no cache returns."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers
    cfg = get_smoke_config("gemma2_9b")
    rng = np.random.default_rng(0)
    p = {n: {"w": rng.normal(size=(64, c)).astype(np.float32) / 8}
         for n, c in (("wq", 64), ("wk", 32), ("wv", 32))}
    p["wo"] = {"w": rng.normal(size=(64, 64)).astype(np.float32) / 8}
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))

    def ref(x):
        o, c = ref_layers.apply_gqa(
            jax.tree.map(jnp.asarray, p), x, ref_smoke("gemma2_9b"),
            kind="train", layer_kind="local", positions=jnp.asarray(pos))
        assert c is None
        return jnp.sum(jnp.tanh(o)), o

    (_, want), want_g = jax.value_and_grad(ref, has_aux=True)(x)
    tx = torch.tensor(x, requires_grad=True)
    out, cache = layers.apply_gqa(
        {n: {"w": torch.from_numpy(v["w"])} for n, v in p.items()}, tx, cfg,
        kind="train", layer_kind="local", positions=torch.from_numpy(pos))
    torch.tanh(out).sum().backward()
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g), **TOL)


# multi-head latent attention's (q/k, v) head_dim pairs: minicpm3-4b's
# (96, 64), its smoke configuration's (24, 16) and deepseek-v2-lite's
# (192, 128), causal and not, with a window, a softcap, GQA and shifted
# queries
# b, h, hkv, sq, skv, (d, dv), causal, window, softcap, q_offset, chunk
MLA_CASES = [(c[:5] + (pair,) + c[5:])
             for pair in ((24, 16), (96, 64), (192, 128))
             for c in ((1, 4, 4, 32, 32, True, None, None, 0, 8),
                       (2, 2, 2, 24, 40, False, None, None, 16, 8),
                       (1, 4, 2, 32, 32, True, 8, 20.0, 0, 16),
                       (1, 2, 1, 24, 24, False, 4, None, -3, 24))]


def _mla_inputs(case):
    b, h, hkv, sq, skv, (d, dv), *_ = case
    rng = np.random.default_rng(sq + skv + d)
    return [rng.normal(size=sh).astype(np.float32) for sh in
            ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv),
             (b, sq, h, dv))]


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_mla_fwd_bwd_match_reference(case):
    """A v head_dim of its own: the port's output (v's width) and its
    gradients (each of its input's width) against the reference's custom
    VJP, which carries v's width ``dv`` through `_fwd_impl` and
    `_bwd_rule`."""
    _, _, _, _, _, _, causal, window, softcap, off, chunk = case
    q, k, v, w = _mla_inputs(case)

    def ref(q, k, v):
        o = flash_attention_xla(q, k, v, causal, window, softcap, off, chunk)
        return jnp.sum(jnp.tanh(o) * w), o

    (_, want_o), want = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    o, got = _port_grads(q, k, v, w, causal=causal, window=window,
                         softcap=softcap, q_offset=off, chunk=chunk)
    assert o.shape == w.shape
    np.testing.assert_allclose(o, np.asarray(want_o), **TOL)
    for g, r, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_mla_lse_matches_reference(case):
    """`flash_attention_fwd_plain` at a v head_dim of its own gives
    `_fwd_impl`'s (o, lse); the scale is 1/sqrt(D) of q and k."""
    b, h, _, sq, _, (d, dv), causal, window, softcap, off, chunk = case
    q, k, v, _ = _mla_inputs(case)
    want_o, want_lse = _fwd_impl(q, k, v, causal, window, softcap, off,
                                 chunk)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o, lse = tfa.flash_attention_fwd_plain(*heads, chunk=chunk, **kw)
    assert o.shape == (b, h, sq, dv)
    want_lse = np.asarray(want_lse).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    assert np.array_equal(lse.numpy() == tfa.BIG, want_lse == tfa.BIG)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want_o),
                               **TOL)
    o2, lse2 = tfa.flash_attention(*heads, return_lse=True, **kw)
    np.testing.assert_allclose(lse2.numpy(), want_lse, **TOL)
    np.testing.assert_allclose(o2.numpy(), o.numpy(), **TOL)


# zamba2-7b's head_dim 112, causal and not, with a window, a softcap, GQA
# and shifted queries (b, h, hkv, sq, skv, (d, dv), causal, window,
# softcap, q_offset, chunk)
HD112_CASES = [(1, 4, 4, 32, 32, (112, 112), True, None, None, 0, 8),
               (2, 4, 2, 24, 40, (112, 112), False, 8, 20.0, 16, 8),
               (1, 4, 1, 32, 32, (112, 112), True, None, 30.0, 5, 16)]


@pytest.mark.parametrize("case", HD112_CASES, ids=str)
def test_head_dim_112_fwd_bwd_match_reference(case):
    """The port's output and gradients at (112, 112) against the
    reference's custom VJP, as the MLA pairs' are."""
    test_mla_fwd_bwd_match_reference(case)


@pytest.mark.parametrize("case", HD112_CASES, ids=str)
def test_head_dim_112_lse_matches_reference(case):
    test_mla_lse_matches_reference(case)
