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
    (((1, 3, 8, 16), (1, 2, 8, 16)), {}, "multiple"),
    (((1, 2, 8, 16), (1, 2, 8, 32)), {}, "do not fit"),
    (((1, 2, 8, 16), (1, 2, 8, 16)), dict(softcap=0.0), "softcap"),
])
def test_wrapper_rejects_bad_input(shapes, kw, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k.clone(), **kw)


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
    """bf16 takes the wgmma kernel, f32 the CUDA-core kernel; both are
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
