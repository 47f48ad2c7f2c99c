"""The port's attention (plain PyTorch route of `flash_attention`, and the
`attention_ref` twin) against the JAX package on the same numpy-seeded
inputs.  Tolerances are those of `tests/test_kernels.py`: 2e-5 in f32,
2e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_fa  # noqa: E402
from repro.models.flash_xla import attend_flash  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_kernels import ATTN_CASES  # noqa: E402

# b, hq, hkv, sq, skv, d, causal, window, softcap: lengths the Pallas
# wrapper refuses (Sq % bq != 0), as serving prompts have them
ODD_CASES = [
    (1, 4, 2, 37, 37, 16, True, None, None),
    (2, 4, 2, 37, 37, 64, True, 16, 50.0),
    (1, 4, 2, 1, 300, 32, True, None, 30.0),
    (1, 4, 2, 37, 300, 64, True, 64, 50.0),
    (1, 2, 2, 37, 300, 16, False, 100, None),
]


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype=jnp.float32):
    """q, k, v as jnp arrays of ``dtype`` and as the same values in torch."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want.astype(jnp.float32))).max())


@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,window,softcap,dtype", ATTN_CASES)
def test_plain_matches_pallas(b, hq, hkv, sq, skv, d, causal, window,
                              softcap, dtype):
    jx, tx = _inputs(b * sq + d, b, hq, hkv, sq, skv, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = pallas_fa(*jx, block_q=64, block_k=64, **kw)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*tx, **kw)
    assert tfa.flash_attention.launches == before  # CPU: no kernel
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    assert _err(got, want) < tol
    assert _err(tref.attention_ref(*tx, **kw),
                jref.attention_ref(*jx, **kw)) < tol


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,softcap",
                         ODD_CASES)
def test_odd_lengths_match_reference(b, hq, hkv, sq, skv, d, causal, window,
                                     softcap):
    jx, tx = _inputs(sq + skv, b, hq, hkv, sq, skv, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tfa.flash_attention(*tx, **kw)
    assert _err(got, jref.attention_ref(*jx, **kw)) < 2e-5
    # the model-side XLA path: [B, S, H, D] layout, right-aligned queries
    q, k, v = (a.transpose(0, 2, 1, 3) for a in jx)
    xla = attend_flash(q, k, v, q_offset=skv - sq, **kw)
    assert _err(got.transpose(1, 2), xla) < 2e-5


def test_strided_views_equal_contiguous():
    """The model hands [B, S, H, D] activations over as [B, H, S, D] views."""
    _, (q, k, v) = _inputs(3, 2, 4, 2, 37, 37, 16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    kw = dict(window=16, softcap=50.0)
    assert torch.equal(tfa.flash_attention(*views, **kw),
                       tfa.flash_attention(q, k, v, **kw))


def test_row_without_keys_is_zero():
    """A row whose keys are all masked has l = 0 -> 1: output 0, not NaN."""
    _, (q, k, v) = _inputs(4, 1, 2, 1, 8, 8, 16)
    out = tfa.flash_attention(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 2, 9, 16), (1, 2, 8, 16)), {}, "exceeds"),
    (((1, 2, 9, 16), (1, 2, 8, 16)), dict(causal=True, window=4),
     "exceeds"),
    (((1, 3, 8, 16), (1, 2, 8, 16)), {}, "multiple"),
    (((1, 2, 8, 16), (1, 2, 8, 32)), {}, "do not fit"),
    (((1, 2, 8, 16), (1, 2, 8, 16)), dict(softcap=0.0), "softcap"),
])
def test_wrapper_rejects_bad_input(shapes, kw, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k.clone(), **kw)


# b, hq, hkv, sq, skv, d, chunk: non-causal calls with Sq > Skv, as the
# encoder-decoder's cross-attention makes them (its smoke decoder's 32 and
# 40 positions over 24 frames), GQA groups 1, 2 and 4, kv chunks that
# divide Skv and one that does not; and Sq = 1 (a decode step's query
# over the frames)
CROSS_CASES = [
    (2, 4, 4, 40, 24, 16, 8),
    (1, 4, 2, 64, 16, 32, 16),
    (1, 8, 2, 100, 24, 16, 512),
    (2, 4, 1, 37, 20, 64, 7),
    (2, 4, 4, 1, 24, 16, 8),
    (1, 8, 2, 1, 300, 64, 512),
]


@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
def test_noncausal_longer_queries_match_flash_xla(case):
    """A non-causal call takes any Sq and Skv: the plain versions (the
    wrapper's CPU route, its lse, and the backward through
    `models.flash_xla.attend_flash`) against the reference's
    `flash_attention_xla` and its custom VJP (rtol = atol = 2e-4, the
    gradient test's bar).  Without a window ``q_offset`` changes nothing:
    the wrapper's default Skv - Sq (negative here) equals the reference's
    0."""
    import jax
    from repro.models.flash_xla import _fwd_impl, flash_attention_xla
    from repro_torch.models.flash_xla import attend_flash as t_attend
    b, hq, hkv, sq, skv, d, chunk = case
    rng = np.random.default_rng(sum(case))
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    w = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    tol = dict(rtol=2e-4, atol=2e-4)

    def ref(q, k, v):
        o = flash_attention_xla(q, k, v, False, None, None, 0, chunk)
        return jnp.sum(jnp.tanh(o) * w), o

    (_, want_o), want_g = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
    heads = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    for off in (None, 0):
        got = tfa.flash_attention(*heads, causal=False, q_offset=off)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   np.asarray(want_o), **tol)
    _, want_lse = _fwd_impl(q, k, v, False, None, None, 0, chunk)
    o, lse = tfa.flash_attention_fwd_plain(*heads, causal=False,
                                           chunk=chunk)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(b, hq, sq), **tol)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(),
                               np.asarray(want_o), **tol)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = t_attend(*ts, causal=False, window=None, softcap=None, chunk=chunk)
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               **tol)
    for t, r in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **tol)
    assert tfa.visible_pairs(sq, skv, causal=False) == sq * skv


def test_wrapper_rejects_mixed_dtypes():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="share"):
        tfa.flash_attention(q, q.bfloat16(), q)


def test_plain_float64_evaluation():
    """f64 inputs take the plain route in f64 (the CPU's numerical
    reference); it agrees with the f32 evaluation to f32 rounding."""
    _, (q, k, v) = _inputs(5, 2, 4, 2, 37, 300, 64)
    kw = dict(window=64, softcap=50.0)
    f64 = tfa.flash_attention(q.double(), k.double(), v.double(), **kw)
    assert f64.dtype == torch.float64
    assert float((f64 - tfa.flash_attention(q, k, v, **kw)).abs().max()) \
        < 2e-6


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "flash_attention_sm90"),
    (torch.float32, "flash_attention"),
])
def test_kernel_route_by_dtype(dtype, route):
    """bf16 takes the wgmma kernel, f32 the 3xTF32 kernel; both are
    libraries the build knows."""
    from repro_torch.kernels import _build
    assert tfa.kernel_route(dtype) == route
    assert route in _build.SIGNATURES
    assert tfa.ROUTES[dtype][1] in _build.SIGNATURES[route]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="no kernel"):
        tfa.kernel_route(dtype)


def _bf16(b, h, s, d):
    return torch.zeros(b, h, s, d, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,want", [
    # contiguous [B, H, S, D]
    (lambda: _bf16(2, 4, 37, 64), [4 * 37 * 64, 37 * 64, 64]),
    # [B, S, H, D] viewed as [B, H, S, D], as the model hands it over
    (lambda: _bf16(2, 37, 4, 64).transpose(1, 2), [37 * 4 * 64, 64, 4 * 64]),
    # dims of size 1 are never stepped: they take their contiguous stride
    (lambda: _bf16(1, 1, 1, 16)[:, :, :1], [16, 16, 16]),
    (lambda: _bf16(1, 8, 2, 32).transpose(1, 2)[:, :1], [8 * 32, 8 * 32,
                                                         2 * 32]),
    # a slice along D with a 16-byte-multiple row stride
    (lambda: _bf16(1, 2, 8, 72)[..., :64], [2 * 8 * 64, 8 * 72, 72]),
])
def test_tma_strides_accepts(make, want):
    assert tfa.tma_strides(make()) == want


@pytest.mark.parametrize("make,match", [
    (lambda: _bf16(1, 2, 8, 80)[..., 1:65], "aligned"),     # base + 2 bytes
    (lambda: _bf16(1, 2, 8, 68)[..., :64], "seq stride"),   # 136-byte rows
    (lambda: _bf16(1, 3, 8, 16)[:, :, :, :8].as_strided(
        (1, 3, 8, 8), (3 * 8 * 8 + 4, 8 * 8 + 4, 8, 1)), "head stride"),
    (lambda: torch.zeros(2, 2, 8, 20, dtype=torch.bfloat16)[..., :16]
     .as_strided((2, 2, 8, 16), (324, 160, 20, 1)), "batch stride"),
])
def test_tma_strides_refuses(make, match):
    """What TMA cannot load raises ValueError naming the rule; the wrapper
    runs this check before any bf16 launch, so such an input never falls
    through to another route."""
    with pytest.raises(ValueError, match=match):
        tfa.tma_strides(make())


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "flash_attention_bwd_sm90"),
    (torch.float32, "flash_attention_bwd"),
])
def test_bwd_kernel_route_by_dtype(dtype, route):
    """The backward routes as the forward does: bf16 to the wgmma kernel,
    f32 to the 3xTF32 kernel; both are libraries the build knows."""
    from repro_torch.kernels import _build
    assert tfa.bwd_kernel_route(dtype) == route
    assert tfa.BWD_ROUTES[dtype][1] in _build.SIGNATURES[route]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_bwd_kernel_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="no kernel"):
        tfa.bwd_kernel_route(dtype)


@pytest.mark.parametrize("loss", ["weighted", "sum"])
def test_tma_strides_accept_backward_inputs(monkeypatch, loss):
    """q, k, v and dO as `FlashAttention.backward` hands them to the
    kernel ([B, S, H, D] viewed as [B, H, S, D]; a dO that autograd
    expands with stride 0, from a plain sum, is made contiguous first)
    pass TMA's checks with the strides of that view."""
    from repro_torch.models import flash_xla
    seen = []

    def capture(*args, **kw):
        seen.extend(args[:3] + args[5:6])
        return tfa.flash_attention_bwd_plain(*args, **kw)
    monkeypatch.setattr(flash_xla, "flash_attention_bwd_plain", capture)
    b, s, d = 2, 37, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(torch.bfloat16)
               .requires_grad_() for h in (4, 2, 2))
    out = flash_xla.attend_flash(q, k, v, causal=True, window=None,
                                 softcap=50.0)
    if loss == "sum":
        out.sum().backward()
    else:
        (out * torch.randn(out.shape, generator=g)).sum().backward()
    assert len(seen) == 4
    for t in seen:
        h = t.shape[1]
        assert tfa.tma_strides(t) == [s * h * d, d, h * d]


@pytest.mark.parametrize("pad_first", [True, False])
def test_backward_copies_a_do_that_tma_cannot_load(monkeypatch, pad_first):
    """A bf16 dO that arrives as a view TMA refuses (a slice of
    torch.cat's gradient along head_dim: at an odd offset, or with strides
    that are not multiples of 16 bytes) reaches the kernel as a dense copy
    with the same values."""
    from repro_torch.models import flash_xla
    seen = []

    def capture(*args, **kw):
        seen.append(args[5])
        return tfa.flash_attention_bwd_plain(*args, **kw)
    monkeypatch.setattr(flash_xla, "flash_attention_bwd_plain", capture)
    b, s, h, d = 2, 37, 4, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    out = flash_xla.attend_flash(q, k, v, causal=True, window=None,
                                 softcap=50.0)
    pad = torch.zeros(b, s, h, 3, dtype=out.dtype)
    y = torch.cat([pad, out] if pad_first else [out, pad], dim=3)
    w = torch.randn(y.shape, generator=g).to(torch.bfloat16)
    grads = []
    out.register_hook(grads.append)
    (y * w).sum().backward()
    view = grads[0].transpose(1, 2)
    assert not tfa.tma_loadable(view)
    assert len(seen) == 1
    assert tfa.tma_strides(seen[0]) == [s * h * d, d, h * d]
    assert torch.equal(seen[0], view)


def _bwd_cases():
    from test_torch_kernels_gpu import BWD_CASES
    return BWD_CASES + [(1, 16, 8, 4096, 4096, 256, True, w, 50.0, None)
                        for w in (None, 4096, 512)]


def _cover(blocks, nrows, ncols, dkdv: bool):
    """How many times each (row, key) of one head lies in a tile that the
    head's ``blocks`` (start, first, tiles) visit, and their tile counts in
    block order."""
    count = np.zeros((nrows, ncols), np.int32)
    step = tfa.BWD_QUERIES if dkdv else tfa.BWD_DQ_KEYS
    for start, first, tiles in blocks:
        for s0 in range(first, first + tiles * step, step):
            if dkdv:  # query tiles of the keys at start
                count[s0:s0 + tfa.BWD_QUERIES, start:start + tfa.BWD_KEYS] += 1
            else:     # kv tiles of the rows at start
                count[start:start + tfa.BWD_ROWS, s0:s0 + tfa.BWD_DQ_KEYS] += 1
    return count, [tiles for _, _, tiles in blocks]


@pytest.mark.parametrize("case", _bwd_cases(), ids=str)
def test_bwd_launch_plan_covers_each_visible_pair_once(case):
    """The block table that the kernels read: every visible (query, key)
    pair lies in exactly one (dk/dv block, query tile) and exactly one (dq
    block, kv tile) that it visits; every (tile, head) has one block, the
    head fastest; blocks run heaviest first."""
    b, hq, hkv, sq, skv, _, causal, window, _, off = case
    plan = tfa.bwd_launch_plan(b, hq, hkv, sq, skv, causal=causal,
                               window=window, q_offset=off)
    mask = tref.attention_mask(sq, skv, causal=causal, window=window,
                               device="cpu", q_offset=off).numpy()
    assert len(plan.args()) == 5 and plan.sq_pad % tfa.BWD_ROWS == 0
    assert plan.sq_pad >= sq
    table = plan.blocks()
    assert table.dtype == np.int32
    assert table.shape == (plan.dkdv_blocks + plan.dq_blocks, 4)
    for rows, heads, dkdv in ((table[:plan.dkdv_blocks], b * hkv, True),
                              (table[plan.dkdv_blocks:], b * hq, False)):
        assert (rows[:, 0] == np.arange(len(rows)) % heads).all()
        by_head = {}
        for head, start, first, tiles in rows.tolist():
            by_head.setdefault(head, []).append((start, first, tiles))
        assert sorted(by_head) == list(range(heads))
        # a head's blocks take each tile once, the same tiles as head 0
        assert all(v == by_head[0] for v in by_head.values())
        count, order = _cover(by_head[0], sq, skv, dkdv)
        assert (count[mask] == 1).all()
        assert count.max(initial=0) <= 1
        if causal:
            assert order == sorted(order, reverse=True)
        starts = sorted(start for start, _, _ in by_head[0])
        step = tfa.BWD_KEYS if dkdv else tfa.BWD_ROWS
        assert starts == list(range(0, skv if dkdv else sq, step))


def test_bwd_launch_plan_clamps_the_window():
    """A window past the range of qpos - kpos masks as that bound: the plan
    passes the same clamped window as the forward kernel computes."""
    far = tfa.bwd_launch_plan(1, 2, 1, 40, 64, causal=True, window=10 ** 12,
                              q_offset=24)
    assert far.window == 24 + 40
    none = tfa.bwd_launch_plan(1, 2, 1, 40, 64, causal=True, window=-10 ** 12,
                               q_offset=24)
    assert none.window == 24 - 64
    assert (none.blocks()[:, 2:] == 0).all()


def test_library_digest_covers_included_headers(monkeypatch, tmp_path):
    """An edited csrc header gives the libraries that include it a new
    path, so they build anew; a library without it keeps its path."""
    import shutil
    from repro_torch.kernels import _build
    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("flash_attention_bwd_sm90")] == [
        "flash_attention_bwd_sm90.cu", "sm90_common.cuh"]
    names = ("flash_attention_sm90", "flash_attention_bwd_sm90",
             "flash_attention_bwd")
    before = {n: _build.library_path(n) for n in names}
    with open(tmp_path / "sm90_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["flash_attention_sm90"] != before["flash_attention_sm90"]
    assert after["flash_attention_bwd_sm90"] != \
        before["flash_attention_bwd_sm90"]
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"]


# multi-head latent attention's (q/k, v) head_dim pairs: minicpm3-4b's
# (96, 64), its smoke configuration's (24, 16) and deepseek-v2-lite's
# (192, 128), causal and not
MLA_CASES = [  # b, hq, hkv, sq, skv, d, dv, causal, window, softcap
    (1, 4, 4, 37, 37, 24, 16, True, None, None),
    (2, 4, 2, 40, 64, 24, 16, False, 16, 20.0),
    (1, 4, 4, 37, 37, 96, 64, True, None, None),
    (1, 2, 1, 30, 50, 96, 64, False, None, None),
    (1, 4, 4, 37, 37, 192, 128, True, None, None),
    (1, 2, 1, 30, 50, 192, 128, False, 16, 20.0),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,dv,causal,window,softcap",
                         MLA_CASES)
def test_mla_plain_matches_reference(b, hq, hkv, sq, skv, d, dv, causal,
                                     window, softcap):
    """A v head_dim of its own on the CPU route: the output has v's width
    and equals the reference's oracle and its XLA attention (which carry
    v's width) within 2e-5."""
    rng = np.random.default_rng(sq + d)
    arrs = [rng.normal(size=(b, h, s, w)).astype(np.float32)
            for h, s, w in ((hq, sq, d), (hkv, skv, d), (hkv, skv, dv))]
    jx, tx = [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                              for a in arrs]
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*tx, **kw)
    assert tfa.flash_attention.launches == before  # CPU: no kernel
    assert got.shape == (b, hq, sq, dv)
    if sq == skv:
        assert _err(got, jref.attention_ref(*jx, **kw)) < 2e-5
    q, k, v = (a.transpose(0, 2, 1, 3) for a in jx)
    xla = attend_flash(q, k, v, q_offset=skv - sq, **kw)
    assert _err(got.transpose(1, 2), xla) < 2e-5


def test_mla_pairs_build_in_their_own_libraries():
    """Every built (D, Dv) pair maps to a library the build knows: the
    square ones to the four attention sources, MLA's to their ``_mla``
    twins (which include those sources, so an edit there rebuilds both);
    a pair not built raises naming the built pairs."""
    from repro_torch.kernels import _build
    assert {(96, 64), (24, 16), (192, 128)} <= set(tfa.HEAD_DIMS)
    for routes in (tfa.ROUTES, tfa.BWD_ROUTES):
        for dtype, route in routes.items():
            for d, dv in tfa.HEAD_DIMS:
                lib, entry = tfa.library(route, d, dv)
                assert entry in _build.SIGNATURES[lib]
                assert lib.endswith("_mla") == ((d, dv) in tfa.MLA_DIMS)
    assert tfa.kernel_route(torch.bfloat16, 96, 64) == \
        "flash_attention_sm90_mla"
    assert tfa.bwd_kernel_route(torch.float32, 24, 16) == \
        "flash_attention_bwd_mla"
    assert tfa.kernel_route(torch.float32, 64, 64) == "flash_attention"
    assert [p.name for p in _build.sources("flash_attention_sm90_mla")] == [
        "flash_attention_sm90_mla.cu", "flash_attention_sm90.cu",
        "sm90_common.cuh"]
    # zamba2's 112 is square: built in the four attention sources
    assert tfa.kernel_route(torch.bfloat16, 112, 112) == \
        "flash_attention_sm90"
    assert tfa.bwd_kernel_route(torch.float32, 112, 112) == \
        "flash_attention_bwd"
    for d, dv in ((96, 32), (24, 24), (48, 48), (112, 64), (192, 96)):
        with pytest.raises(ValueError, match=r"built \(D, Dv\) pairs"):
            tfa.library(tfa.ROUTES[torch.bfloat16], d, dv)


def test_mla_fake_kernels_and_flops():
    """The ops' fake CUDA implementations give o and dv v's width, o in
    q's layout (no card is needed to fake one), and the FLOP formulas
    count 2 (D + Dv) a visible pair forward and 2 (3 D + 2 Dv) backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        q = torch.empty(1, 10, 4, 96, device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)
        k = torch.empty(1, 2, 12, 96, device="cuda", dtype=torch.bfloat16)
        v = torch.empty(1, 2, 12, 64, device="cuda", dtype=torch.bfloat16)
        o, lse = torch.ops.repro_torch.flash_attention(
            q, k, v, True, None, None, None, 128, 128, None, True)
        assert o.shape == (1, 4, 10, 64) and o.stride() == (2560, 64, 256, 1)
        grads = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, o, lse, o, True, None, None, None, None)
        assert [tuple(g.shape) for g in grads] == [
            (1, 4, 10, 96), (1, 2, 12, 96), (1, 2, 12, 64)]
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(1, 4, n, 24, generator=g) for n in (20, 24))
    v = torch.randn(1, 4, 24, 16, generator=g)
    pairs = tfa.visible_pairs(20, 24, causal=True)
    with FlopCounterMode(display=False) as fc:
        o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    assert fc.get_total_flops() == 2 * (24 + 16) * 4 * pairs
    with FlopCounterMode(display=False) as fc:
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o))
    assert fc.get_total_flops() == 2 * (3 * 24 + 2 * 16) * 4 * pairs


# zamba2-7b's head_dim 112 (its shared attention block; 32/32 heads), in
# both dtypes, causal and not, with GQA, a window and a softcap; lengths
# that the Pallas wrapper takes (multiples of its 64-row tiles)
HD112_CASES = [  # b, hq, hkv, sq, skv, causal, window, softcap, dtype
    (1, 4, 4, 64, 64, True, None, None, jnp.float32),
    (2, 4, 2, 64, 128, True, 32, 50.0, jnp.float32),
    (1, 4, 1, 128, 128, False, None, 30.0, jnp.float32),
    (1, 4, 4, 64, 64, True, None, None, jnp.bfloat16),
    (1, 4, 2, 128, 128, False, 64, 2.0, jnp.bfloat16),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,softcap,dtype",
                         HD112_CASES)
def test_head_dim_112_matches_pallas(b, hq, hkv, sq, skv, causal, window,
                                     softcap, dtype):
    """The plain route at (112, 112) against the Pallas kernel in
    interpret mode and the reference's oracle, 2e-5 in f32 and 2e-2 in
    bf16; on odd lengths the reference's XLA attention."""
    jx, tx = _inputs(sq + skv, b, hq, hkv, sq, skv, 112, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = pallas_fa(*jx, block_q=64, block_k=64, **kw)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*tx, **kw)
    assert tfa.flash_attention.launches == before  # CPU: no kernel
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    assert _err(got, want) < tol
    if sq == skv:
        assert _err(got, jref.attention_ref(*jx, **kw)) < tol
    jx, tx = _inputs(7, b, hq, hkv, 37, 45, 112)
    got = tfa.flash_attention(*tx, **kw)
    q, k, v = (a.transpose(0, 2, 1, 3) for a in jx)
    xla = attend_flash(q, k, v, q_offset=45 - 37, **kw)
    assert _err(got.transpose(1, 2), xla) < 2e-5
