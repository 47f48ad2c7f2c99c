"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test carries the ``gpu`` marker and skips without a card (a
CUDA kernel has no CPU mode); the file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.core import build_bisim  # noqa: E402
from repro_torch.exmem import build_bisim_oocore  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, SQUARE_DIMS)
from test_torch_staging import column_cases  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _lanes(seed, n, nb, *, sort_eb=None):
    """Fold lanes with u32 values >= 2^31, local_src in [-1, nb + 2)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-1, nb + 2, n)
    a = rng.integers(0, 4, n) - 2 ** 31 + 5
    b = rng.integers(0, 50, n) + 2 ** 31 - 7
    if sort_eb:
        order = np.lexsort((b, a, s, np.arange(n) // sort_eb))
        s, a, b = s[order], a[order], b[order]
    return [torch.from_numpy(a.astype(np.int32)),
            torch.from_numpy(b.astype(np.int64).astype(np.int32)),
            torch.from_numpy(s.astype(np.int32)),
            torch.from_numpy(rng.random(n) < 0.85)]


@pytest.mark.parametrize("dedup,presorted,eb", [
    (False, False, 1 << 12), (True, True, 1 << 12), (True, False, 256),
    (True, False, 4096), (True, False, tfold.MAX_SORTED_EDGES_PER_BLOCK)])
def test_kernel_matches_plain(cuda, dedup, presorted, eb):
    lanes = [x.to(cuda) for x in _lanes(eb, 4 * eb, 64,
                                         sort_eb=eb if presorted else None)]
    kw = dict(nodes_per_block=64, edges_per_block=eb, dedup=dedup,
              presorted=presorted)
    before = tfold.sig_fold.launches
    got = tfold.sig_fold(*lanes, **kw)
    torch.cuda.synchronize()
    assert tfold.sig_fold.launches == before + 1
    for g, w in zip(got, tfold.sig_fold_plain(*lanes, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("presorted", [True, False])
def test_kernel_dedup_never_spans_blocks(cuda, presorted):
    n = 1 << 12
    lanes = [torch.full((n,), 2, dtype=torch.int32, device=cuda),
             torch.full((n,), 9, dtype=torch.int32, device=cuda),
             torch.zeros(n, dtype=torch.int32, device=cuda),
             torch.ones(n, dtype=torch.bool, device=cuda)]
    kw = dict(nodes_per_block=2, edges_per_block=256, dedup=True,
              presorted=presorted)
    hi, lo = tfold.sig_fold(*lanes, **kw)
    want_hi, want_lo = tfold.sig_fold_plain(*lanes, **kw)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert bool((hi[0::2] == hi[0]).all()) and int(hi[0]) != 0


def test_kernel_rejects_oversized_sort_block(cuda):
    eb = 2 * tfold.MAX_SORTED_EDGES_PER_BLOCK
    lanes = [x.to(cuda) for x in _lanes(0, eb, 8)]
    with pytest.raises(ValueError, match="shared memory"):
        tfold.sig_fold(*lanes, nodes_per_block=8, edges_per_block=eb,
                       dedup=True)


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_build_equals_cpu_build(cuda, mode):
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    before = tfold.sig_fold.launches
    card = build_bisim(g, 6, mode=mode, with_store=True, device=cuda)
    assert tfold.sig_fold.launches > before
    cpu = build_bisim(g, 6, mode=mode, with_store=True, device="cpu")
    np.testing.assert_array_equal(card.pids, cpu.pids)
    assert card.counts == cpu.counts and card.next_pid == cpu.next_pid
    for a, b in zip(card.stores, cpu.stores):
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.pids, b.pids)


def _chunk_lanes(seed, n, chunk_edges, *, hub=False):
    """One sorted chunk as the out-of-core build lays it out: dense
    ascending seg over n real lanes, padding seg = chunk_edges - 1,
    eLabel/pId >= 2^31 as u32, duplicate triples."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n, np.int64) if hub else np.sort(rng.integers(0, n, n))
    a = rng.integers(0, 3, n) - 2 ** 31 + 5
    b = rng.integers(0, 5, n) + 2 ** 31 - 7
    order = np.lexsort((b, a, src))
    src, a, b = src[order], a[order], b[order]
    new = np.ones(n, bool)
    new[1:] = src[1:] != src[:-1]
    lanes = np.zeros((3, chunk_edges), np.int32)
    lanes[0, :n] = a.astype(np.int32)
    lanes[1, :n] = b.astype(np.int32)
    lanes[2, :n] = np.cumsum(new) - 1
    lanes[2, n:] = chunk_edges - 1
    return [torch.from_numpy(x) for x in lanes] + [
        torch.arange(chunk_edges) < n]


@pytest.mark.parametrize("n,chunk_edges,hub", [
    (1 << 10, 1 << 10, False), (1000, 1 << 10, True),
    ((1 << 16) - 5, 1 << 16, False), (0, 1 << 12, False)])
@pytest.mark.parametrize("dedup,keep0", [(True, True), (True, False),
                                         (False, True)])
def test_chunk_kernel_matches_plain(cuda, n, chunk_edges, hub, dedup, keep0):
    lanes = [x.to(cuda) for x in _chunk_lanes(n, n, chunk_edges, hub=hub)]
    kw = dict(num_segments=chunk_edges, dedup=dedup)
    before = tfold.chunk_sig_fold.launches
    got = tfold.chunk_sig_fold(*lanes, keep0, **kw)
    torch.cuda.synchronize()
    assert tfold.chunk_sig_fold.launches == before + 1
    for g, w in zip(got, tfold.chunk_sig_fold_plain(*lanes, keep0, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_oocore_equals_cpu_oocore(cuda, tmp_path, mode):
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    kw = dict(mode=mode, chunk_edges=1 << 11, spill_threshold=1 << 10)
    before = tfold.chunk_sig_fold.launches
    card = build_bisim_oocore(g, 6, workdir=str(tmp_path / "card"),
                              device=cuda, **kw)
    assert tfold.chunk_sig_fold.launches > before
    cpu = build_bisim_oocore(g, 6, workdir=str(tmp_path / "cpu"),
                             device="cpu", **kw)
    assert card.counts == cpu.counts
    assert card.converged_at == cpu.converged_at
    assert card.io.to_dict() == cpu.io.to_dict()
    for a, b in zip(card.pid_paths, cpu.pid_paths):
        np.testing.assert_array_equal(np.load(a), np.load(b))


def _run_lanes(seed, n, nb, run_len):
    """Lanes whose src comes in runs of ``run_len`` (random order when
    None), cycling through [-1, nb + 2) so that whole runs fall out; a few
    lanes inside runs take an out-of-range src or are invalid; eLabel and
    pId >= 2^31 as u32, constant over short stretches so that adjacent
    duplicates occur."""
    rng = np.random.default_rng(seed)
    if run_len is None:
        s = rng.integers(-1, nb + 2, n)
    else:
        s = (np.arange(n) // run_len) % (nb + 3) - 1
    holes = rng.random(n) < 0.03
    s[holes] = rng.choice([-7, nb, nb + 5], int(holes.sum()))
    stretch = np.arange(n) // 5
    a = (stretch * 7 + rng.integers(0, 2, n)) % 3 - 2 ** 31 + 5
    b = (stretch % 4) + 2 ** 31 - 7
    valid = rng.random(n) < 0.9
    return [a.astype(np.int64).astype(np.int32),
            b.astype(np.int64).astype(np.int32), s.astype(np.int32), valid]


def _on_card(cols, cuda, layout):
    """The columns on the card: each its own contiguous tensor
    (``contig``), or one lane into a wider buffer, so that no column is
    16-byte aligned and the kernel reads one lane a thread (``view``)."""
    if layout == "contig":
        return [torch.from_numpy(c).to(cuda) for c in cols]
    n = cols[0].shape[0]
    ints = torch.zeros((3, n + 1), dtype=torch.int32, device=cuda)
    ints[:, 1:] = torch.from_numpy(np.stack(cols[:3])).to(cuda)
    valid = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
    valid[1:] = torch.from_numpy(cols[3]).to(cuda)
    return [ints[0, 1:], ints[1, 1:], ints[2, 1:], valid[1:]]


def _vec(cols):
    return tfold.launch_plan(cols[0].numel(), [c.data_ptr() for c in cols],
                             132).vec


# n, edges_per_block, nodes_per_block, run length: one block with runs
# longer than a warp's 128 lanes and than a CTA's 1024; n % 4 != 0; odd
# block sizes whose boundaries cut runs, threads, warps and CTAs; blocks
# of 3 and of 1 lane (several blocks inside one thread); unsorted lanes
FLAT_CASES = [(1 << 16, 1 << 16, 300, 200), (1 << 16, 1 << 16, 12, 3000),
              (50_003, 50_003, 1000, 70), (37 * 999, 999, 9, 70),
              (3 * 4096, 3, 2, 5), (5001, 1, 1, 4),
              (1 << 16, 1 << 16, 5000, None), (64 * 1000, 1000, 40, None)]


@pytest.mark.parametrize("layout", ["contig", "view"])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("n,eb,nb,run_len", FLAT_CASES)
def test_flat_fold_runs_match_plain(cuda, n, eb, nb, run_len, dedup, layout):
    """The flat kernel's pre-reduction against the plain version: runs
    across every boundary, holes inside runs, both load widths."""
    lanes = _on_card(_run_lanes(n + eb, n, nb, run_len), cuda, layout)
    assert _vec(lanes) == (4 if layout == "contig" else 1)
    kw = dict(nodes_per_block=nb, edges_per_block=eb, dedup=dedup,
              presorted=True)
    before = tfold.sig_fold.launches
    got = tfold.sig_fold(*lanes, **kw)
    torch.cuda.synchronize()
    assert tfold.sig_fold.launches == before + 1
    want = tfold.sig_fold_plain(*lanes, **kw)
    assert got.dtype == torch.int64 and got.shape == (2, (n // eb) * nb)
    assert torch.equal(got, want)


def _dense_chunk(seed, n, *, hub=False, sort=True, pad=0):
    """A chunk as the out-of-core build now uploads it: n real lanes with
    dense ascending seg (one segment with ``hub``, unsorted ids without
    ``sort``), then ``pad`` lanes with seg = u; u32 values >= 2^31; a tenth
    of the lanes invalid.  Returns (columns, u)."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n, np.int64) if hub else rng.integers(0, n // 6 + 1, n)
    a = rng.integers(0, 3, n) - 2 ** 31 + 5
    b = rng.integers(0, 3, n) + 2 ** 31 - 7
    order = np.lexsort((b, a, src))
    src, a, b = src[order], a[order], b[order]
    new = np.ones(n, bool)
    new[1:] = src[1:] != src[:-1]
    seg = np.cumsum(new) - 1
    u = int(new.sum())
    if not sort:
        seg = rng.permutation(u)[seg]
    lanes = np.zeros((3, n + pad), np.int32)
    lanes[0, :n] = a.astype(np.int64).astype(np.int32)
    lanes[1, :n] = b.astype(np.int64).astype(np.int32)
    lanes[2, :n] = seg
    lanes[2, n:] = u
    return [*lanes, rng.random(n + pad) < 0.9], u


# n, pad, layout: runs of ~6 lanes; n % 4 != 0 padded as the build pads
# it, or not padded; one hub segment longer than a CTA; unsorted ids;
# num_segments below the largest seg
CHUNK_CASES = [((1 << 16), 0, "sorted"), ((1 << 16) + 3, 1, "sorted"),
               (50_001, 0, "sorted"), (1 << 18, 0, "hub"),
               (1 << 16, 0, "unsorted"), (1 << 16, 0, "fewer_rows")]


@pytest.mark.parametrize("layout", ["contig", "view"])
@pytest.mark.parametrize("dedup,keep0", [(True, True), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("n,pad,kind", CHUNK_CASES)
def test_chunk_fold_runs_match_plain(cuda, n, pad, kind, dedup, keep0,
                                     layout):
    cols, u = _dense_chunk(n + pad, n, hub=kind == "hub",
                           sort=kind != "unsorted", pad=pad)
    lanes = _on_card(cols, cuda, layout)
    assert _vec(lanes) == (4 if layout == "contig" else 1)
    kw = dict(num_segments=u // 2 if kind == "fewer_rows" else u,
              dedup=dedup)
    before = tfold.chunk_sig_fold.launches
    got = tfold.chunk_sig_fold(*lanes, keep0, **kw)
    torch.cuda.synchronize()
    assert tfold.chunk_sig_fold.launches == before + 1
    want = tfold.chunk_sig_fold_plain(*lanes, keep0, **kw)
    assert got.dtype == torch.int64 and got.shape == (2, kw["num_segments"])
    assert torch.equal(got, want)


def test_fold_wrappers_raise_on_card(cuda):
    """On the card a wrapper launches its kernel or raises: a strided
    column is refused, and nothing is launched."""
    cols, u = _dense_chunk(0, 1024)
    lanes = [torch.from_numpy(c).to(cuda) for c in cols]
    strided = torch.zeros(2048, dtype=torch.int32, device=cuda)[::2]
    before = (tfold.chunk_sig_fold.launches, tfold.sig_fold.launches)
    with pytest.raises(ValueError, match="contiguous"):
        tfold.chunk_sig_fold(strided, *lanes[1:], True, num_segments=u)
    with pytest.raises(ValueError, match="contiguous"):
        tfold.sig_fold(strided, *lanes[1:], nodes_per_block=u,
                       edges_per_block=1024)
    assert (tfold.chunk_sig_fold.launches, tfold.sig_fold.launches) == before


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_oocore_odd_chunks_equal_cpu(cuda, tmp_path, mode):
    """Chunks of 1003 edges: most uploads are padded to a multiple of 4
    lanes; each folds into its distinct-source count."""
    g = gen.powerlaw_graph(2000, 9000, 4, 3, seed=2)
    kw = dict(mode=mode, chunk_edges=1003, spill_threshold=1 << 10)
    before = tfold.chunk_sig_fold.launches
    card = build_bisim_oocore(g, 5, workdir=str(tmp_path / "card"),
                              device=cuda, **kw)
    assert tfold.chunk_sig_fold.launches > before
    cpu = build_bisim_oocore(g, 5, workdir=str(tmp_path / "cpu"),
                             device="cpu", **kw)
    assert card.counts == cpu.counts
    assert card.converged_at == cpu.converged_at
    assert card.io.to_dict() == cpu.io.to_dict()
    for a, b in zip(card.pid_paths, cpu.pid_paths):
        np.testing.assert_array_equal(np.load(a), np.load(b))


BF16 = torch.bfloat16
# b, hq, hkv, sq, skv, d, causal, window, softcap, dtype: the cases of
# `tests/test_kernels.py::ATTN_CASES`, the odd lengths serving prompts
# have, and gemma2-9b's head_dim 256 with its window and softcap; then both
# kernels (bf16 wgmma, f32 3xTF32) at every head_dim, ragged lengths, GQA
# groups 1, 2 and 8, window and softcap each on and off, and gemma2-9b's
# 8192-token prefill in bf16
DTYPES = (torch.float32, BF16)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None, torch.float32),
    (1, 8, 1, 256, 256, 32, True, None, 30.0, torch.float32),
    (2, 2, 2, 128, 256, 64, True, 64, None, torch.float32),
    (1, 4, 4, 128, 128, 128, False, None, None, torch.float32),
    (1, 2, 1, 128, 128, 64, True, None, None, BF16),
    (1, 2, 2, 64, 64, 16, True, 32, 20.0, torch.float32),
    (1, 4, 2, 37, 37, 16, True, None, None, torch.float32),
    (1, 4, 2, 1, 300, 64, True, None, 50.0, torch.float32),
    (2, 4, 2, 37, 300, 64, True, 64, 50.0, torch.float32),
    (2, 16, 8, 300, 300, 256, True, 128, 50.0, torch.float32),
    (2, 16, 8, 300, 300, 256, True, 128, 50.0, BF16),
] + [(1, 4, 2, 200, 200, d, True, None, None, dt) for d in SQUARE_DIMS
      for dt in DTYPES] + [
    (1, 4, 4, 256, 256, d, False, None, 30.0, dt) for d in SQUARE_DIMS
    for dt in DTYPES
] + [(2, 4, 2, sq, skv, 64, True, 16, 50.0, dt)
     for sq, skv in ((1, 300), (37, 37), (37, 300), (300, 300))
     for dt in DTYPES] + [
    (1, hq, hkv, 150, 250, 128, True, None, None, dt)
    for hq, hkv in ((4, 4), (4, 2), (8, 1)) for dt in DTYPES
] + [(1, 4, 2, 300, 300, 256, True, window, softcap, dt)
     for window in (None, 100) for softcap in (None, 50.0)
     for dt in DTYPES] + [
    (1, 16, 8, 8192, 8192, 256, True, None, 50.0, BF16),
]


def _qkv(cuda, seed, b, hq, hkv, sq, skv, d, dtype, dv=None):
    """q, k of head_dim ``d`` and v of ``dv`` (default ``d``)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, h, s, w, generator=g, device=cuda).to(dtype)
            for h, s, w in ((hq, sq, d), (hkv, skv, d), (hkv, skv, dv or d))]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,softcap,dtype",
                         FLASH_CASES)
def test_flash_attention_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                       window, softcap, dtype):
    from repro_torch.kernels import flash_attention as tfa
    qkv = _qkv(cuda, sq + d, b, hq, hkv, sq, skv, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_plain(*qkv, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) < tol
    # block_q and block_k bound only the CPU route: each kernel takes its
    # own tiles
    for bq, bk in ((16, 64), (64, 32), (37, 5)):
        other = tfa.flash_attention(*qkv, block_q=bq, block_k=bk, **kw)
        assert float((other.float() - got.float()).abs().max()) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (BF16, 2e-2)])
def test_flash_attention_strided_views(cuda, dtype, tol):
    """[B, S, H, D] activations viewed as [B, H, S, D], as the model hands
    them over; the output takes q's layout."""
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(cuda, 0, 2, 4, 2, 37, 37, 64, dtype))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, window=16)
    assert tfa.flash_attention.launches == before + 1
    assert out.stride() == q.stride()
    want = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window=16)
    assert float((out.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("width,cut,match", [
    (80, slice(1, 65), "aligned"),       # data_ptr 2 bytes off 16
    (68, slice(0, 64), "multiples"),     # seq stride 136 bytes
])
def test_flash_attention_bf16_misaligned_raises(cuda, width, cut, match):
    """TMA needs 16-byte aligned bases and strides: the bf16 kernel refuses
    such a view with ValueError, and nothing is launched (no fallback to
    the f32 kernel or the plain version)."""
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = (t[..., cut] for t in _qkv(cuda, 0, 1, 2, 2, 8, 8, width,
                                           BF16))
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before


def test_flash_attention_refused_launch_raises(cuda):
    """B * Hq above the grid's 65535 is refused by the card: the wrapper
    raises instead of returning an unwritten output."""
    from repro_torch.kernels import flash_attention as tfa
    for dtype in (torch.float32, BF16):
        q = torch.zeros(1, 65536, 1, 16, device=cuda, dtype=dtype)
        before = tfa.flash_attention.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            tfa.flash_attention(q, q, q)
        assert tfa.flash_attention.launches == before
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(*_qkv(cuda, 0, 1, 2, 2, 8, 8, 48, torch.float32))
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(*_qkv(cuda, 0, 1, 2, 2, 8, 8, 64, torch.float64))


# the backward's cases: the reference's gradient test (`tests/test_models.py::
# test_flash_xla_grads_match_reference`), causal on and off, window,
# softcap, GQA groups 1, 2 and 4, right-aligned and shifted queries, rows
# with no key (q_offset < 0; window 0), every head_dim, gemma2's heads; a
# GQA group of 8; and gemma2's heads at 1,000 tokens with a window of 512,
# which turns the bf16 kernel's rings many times over full and edge tiles
BWD_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset
    (2, 4, 2, 64, 64, 16, True, 16, 25.0, 0),
    (1, 2, 2, 48, 48, 32, False, None, None, 0),
    (1, 4, 2, 48, 48, 32, True, None, None, 0),
    (1, 4, 4, 40, 64, 64, True, 8, None, 24),
    (2, 4, 2, 40, 40, 64, True, None, 30.0, 7),
    (1, 4, 1, 33, 33, 128, True, 4, 50.0, -5),
    (1, 2, 1, 16, 16, 16, True, 0, None, 0),
    (1, 4, 2, 100, 100, 256, False, None, 50.0, 0),
    (1, 16, 8, 200, 200, 256, True, 64, 50.0, 0),
    (1, 8, 1, 70, 70, 64, True, None, None, 0),
    (1, 16, 8, 1000, 1000, 256, True, 512, 50.0, 0),
    # softcaps that the logits reach (s ~ N(0, 1)): at 25 or 50, |s / cap|
    # stays under 0.2 and the capped rule is within 1e-3 of the uncapped
    (2, 4, 2, 64, 64, 16, True, 16, 2.0, 0),
    (2, 4, 2, 100, 100, 128, False, None, 1.0, 0),
    (1, 8, 1, 70, 70, 64, True, None, 3.0, 0),
    (1, 16, 8, 200, 200, 256, True, 64, 2.0, 0),
]


def _bwd_inputs(cuda, case, dtype, dv=None):
    """q, k, v (of head_dim ``dv``, default q's), the plain forward's o
    and lse, and dO, on the card."""
    from repro_torch.kernels import flash_attention as tfa
    b, hq, hkv, sq, skv, d, causal, window, softcap, off = case
    q, k, v = _qkv(cuda, sq + d, b, hq, hkv, sq, skv, d, dtype, dv)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    return (q, k, v, o, lse.float(), do), kw


def _routes_called(monkeypatch):
    """The libraries that the attention wrappers call from now on."""
    from repro_torch.kernels import flash_attention as tfa
    called, call = [], tfa._call

    def record(route, *args):
        called.append(route)
        return call(route, *args)
    monkeypatch.setattr(tfa, "_call", record)
    return called


def _bwd_close(got, want, dtype, tol):
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol,route", [
    (torch.float32, 1e-4, "flash_attention_bwd"),
    (BF16, 2e-2, "flash_attention_bwd_sm90")])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_attention_bwd_matches_plain(cuda, monkeypatch, case, dtype,
                                           tol, route):
    """dq, dk, dv of the backward kernel against `_bwd_rule`'s port on
    the card, each within ``tol`` of its largest |x|: f32 1e-4 (the
    CUDA-core kernel), bf16 2e-2 (the wgmma kernel; bf16 p, ds and
    outputs)."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert called == [route] == [tfa.bwd_kernel_route(dtype)]
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 2e-2)])
def test_flash_attention_bwd_strided_views(cuda, dtype, tol):
    """[B, S, H, D] activations and dO viewed as [B, H, S, D], as
    `FlashAttention.backward` hands them over; each gradient takes its
    input's layout."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, (2, 8, 4, 100, 100, 128, True, 48, 50.0,
                                  0), dtype)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             if t.dim() == 4 else t for t in args]
    assert not views[0].is_contiguous()
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*views, **kw)
    assert tfa.flash_attention_bwd.launches == before + 1
    for g, t in zip(got, views):
        assert g.stride() == t.stride()
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype, tol)


@pytest.mark.parametrize("width,cut,match", [
    (80, slice(1, 65), "aligned"),       # data_ptr 2 bytes off 16
    (68, slice(0, 64), "multiples"),     # seq stride 136 bytes
])
@pytest.mark.parametrize("which", range(4))  # q, k, v, do
def test_flash_attention_bwd_bf16_misaligned_raises(cuda, width, cut, match,
                                                    which):
    """A bf16 q, k, v or dO that TMA cannot load raises ValueError and
    launches nothing: no fallback to the f32 kernel or the plain
    version."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, (1, 2, 2, 8, 8, 64, True, None, None, 0),
                           BF16)
    at = (0, 1, 2, 5)[which]
    wide = torch.zeros(*args[at].shape[:3], width, dtype=BF16, device=cuda)
    wide[..., cut] = args[at]
    args = list(args)
    args[at] = wide[..., cut]
    before = tfa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_bwd(*args, **kw)
    assert tfa.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, (1, 16, 8, 300, 300, 256, True, 128, 50.0,
                                  0), dtype)
    first = tfa.flash_attention_bwd(*args, **kw)
    second = tfa.flash_attention_bwd(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 1e-3)])
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_attention_lse_matches_plain(cuda, case, dtype, tol):
    """Both forward kernels' lse against `_fwd_impl`'s port (+BIG rows
    equal), and their output with the lse equal to the output without."""
    from repro_torch.kernels import flash_attention as tfa
    (q, k, v, _, want, _), kw = _bwd_inputs(cuda, case, dtype)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert torch.equal(o, tfa.flash_attention(q, k, v, **kw))
    big = want == tfa.BIG
    assert torch.equal(lse == tfa.BIG, big)
    err = (lse - want).abs().masked_fill(big, 0.0)
    scale = float(want.masked_fill(big, 0.0).abs().max())
    assert float(err.max()) <= tol * max(1.0, scale)


def test_flash_attention_bwd_refuses(cuda):
    """A type, head_dim or lse the kernel does not take raises; nothing
    falls back to the plain version."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, BWD_CASES[0], torch.float32)
    before = tfa.flash_attention_bwd.launches
    q, k, v, o, lse, do = args
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bwd(*(t.double() for t in (q, k, v, o)), lse,
                                do.double(), **kw)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(*args[:4], args[4][..., :-1], args[5], **kw)
    assert tfa.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 3e-2)])
def test_attend_flash_card_grads_equal_cpu(cuda, dtype, tol):
    """`attend_flash`'s gradients on the card (both kernels) against the
    CPU's plain route, in the layers' [B, S, H, D] convention."""
    from repro_torch.models.flash_xla import attend_flash
    g = torch.Generator().manual_seed(0)
    shapes = ((1, 96, 16, 256), (1, 96, 8, 256), (1, 96, 8, 256))
    cpu = [torch.randn(sh, generator=g).to(dtype).requires_grad_()
           for sh in shapes]
    card = [t.detach().to(cuda).requires_grad_() for t in cpu]
    w = torch.randn(shapes[0], generator=g)
    kw = dict(causal=True, window=32, softcap=50.0)
    for ts, ww in ((cpu, w), (card, w.to(cuda))):
        (attend_flash(*ts, **kw).float() * ww).sum().backward()
    for c, d in zip(cpu, card):
        scale = float(c.grad.float().abs().max())
        assert float((d.grad.cpu().float() - c.grad.float()).abs().max()) \
            <= tol * scale


def test_card_serve_equals_cpu_serve(cuda):
    """The smoke configuration served on the card (every prefill attention
    through the kernel) gives the CPU's tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("gemma2_9b")
    cpu = Model(cfg).init(0, device="cpu")
    card = Model(cfg).load(tree_map(lambda t: t.to(cuda), cpu.params))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (21, 5, 21, 40, 21)]
    before = tfa.flash_attention.launches
    eng = ServeEngine(card, max_batch=2, max_seq=64)
    got = eng.serve(reqs, max_new=8)
    assert tfa.flash_attention.launches - before == (cfg.num_layers
                                                     * eng.stats.waves)
    assert got == ServeEngine(cpu, max_batch=2, max_seq=64).serve(
        reqs, max_new=8)


# multi-head latent attention's pairs, (q/k head_dim, v head_dim):
# minicpm3-4b's (96, 64), its smoke configuration's (24, 16) and
# deepseek-v2-lite's (192, 128), each in both dtypes; causal and not, GQA,
# windows, softcaps that the logits reach, shifted queries and rows with no
# key, and the model's heads (minicpm3's 40, deepseek's 16) at 1,000 tokens
MLA_PAIRS = ((96, 64), (24, 16), (192, 128))
MLA_CASES = [  # b, hq, hkv, sq, skv, (d, dv), causal, window, softcap, off
    (c[:5] + (pair,) + c[5:]) for pair in MLA_PAIRS for c in (
        (1, 4, 4, 100, 100, True, None, None, 0),
        (2, 4, 4, 64, 64, False, None, None, 0),
        (1, 8, 2, 70, 70, True, None, 2.0, 0),
        (1, 4, 1, 40, 64, True, 16, None, 24),
        (2, 4, 2, 33, 33, False, 8, 3.0, -5),
        (1, 16 if pair == (192, 128) else 40, 16 if pair == (192, 128)
         else 40, 1000, 1000, True, None, None, 0))]


def _mla_args(cuda, case, dtype):
    """A `MLA_CASES` case as `_bwd_inputs` gives it: (q, k, v, o, lse, dO)
    and the mask's keywords."""
    b, hq, hkv, sq, skv, (d, dv), causal, window, softcap, off = case
    return _bwd_inputs(cuda, (b, hq, hkv, sq, skv, d, causal, window,
                              softcap, off), dtype, dv)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (BF16, 2e-2)])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_flash_attention_mla_matches_plain(cuda, monkeypatch, case, dtype,
                                           tol):
    """The forward at a v head_dim of its own, against the plain version:
    one launch of the pair's library, an output of v's width, the lse."""
    from repro_torch.kernels import flash_attention as tfa
    (q, k, v, _, want_lse, _), kw = _mla_args(cuda, case, dtype)
    d, dv = case[5]
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert called == [tfa.kernel_route(dtype, d, dv)]
    assert called[0].endswith("_mla")
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape == (
        *q.shape[:3], dv)
    assert float((got.float() - want.float()).abs().max()) < tol
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, got)
    big = want_lse == tfa.BIG
    assert torch.equal(lse == tfa.BIG, big)
    scale = max(1.0, float(want_lse.masked_fill(big, 0.0).abs().max()))
    lse_tol = 1e-3 if dtype == BF16 else 1e-4
    assert float((lse - want_lse).abs().masked_fill(big, 0.0).max()) \
        <= lse_tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 2e-2)])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_flash_attention_mla_bwd_matches_plain(cuda, monkeypatch, case,
                                               dtype, tol):
    """dq, dk (q/k's width) and dv (v's) of the backward at MLA's pairs
    against `_bwd_rule`'s port, each within ``tol`` of its largest |x|."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _mla_args(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert called == [tfa.bwd_kernel_route(dtype, *case[5])]
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype, tol)


@pytest.mark.parametrize("pair", MLA_PAIRS)
@pytest.mark.parametrize("dtype,tol,bwd_tol", [(torch.float32, 2e-5, 1e-4),
                                               (BF16, 2e-2, 2e-2)])
def test_flash_attention_mla_strided_views(cuda, pair, dtype, tol, bwd_tol):
    """[B, S, H, D] q, k and [B, S, H, Dv] v viewed as [B, H, S, D], as
    the MLA layer hands them over: the output takes q's layout at v's
    width, each gradient its input's layout."""
    from repro_torch.kernels import flash_attention as tfa
    d, dv = pair
    args, kw = _bwd_inputs(cuda, (2, 8, 8, 100, 100, d, True, None, None,
                                  0), dtype, dv)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             if t.dim() == 4 else t for t in args]
    q, k, v = views[:3]
    out = tfa.flash_attention(q, k, v, **kw)
    assert out.shape == (2, 8, 100, dv)
    assert out.stride() == (100 * 8 * dv, dv, 8 * dv, 1)
    want = tfa.flash_attention_plain(*args[:3], **kw)
    assert float((out.float() - want.float()).abs().max()) < tol
    got = tfa.flash_attention_bwd(*views, **kw)
    for g, t in zip(got, views):
        assert g.stride() == t.stride()
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype,
               bwd_tol)


@pytest.mark.parametrize("pair", MLA_PAIRS)
def test_flash_attention_mla_bwd_is_deterministic(cuda, pair):
    """The bf16 backward at MLA's pairs: two calls give the same bits."""
    from repro_torch.kernels import flash_attention as tfa
    d, dv = pair
    args, kw = _bwd_inputs(cuda, (1, 8, 4, 300, 300, d, True, 128, None,
                                  0), BF16, dv)
    first = tfa.flash_attention_bwd(*args, **kw)
    second = tfa.flash_attention_bwd(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("pair", [(96, 32), (24, 24), (64, 16), (48, 48)])
def test_flash_attention_unbuilt_pair_raises(cuda, dtype, pair):
    """A (q/k, v) head_dim pair that no library is built for raises
    ValueError naming the built pairs, forward and backward, and nothing
    is launched: no padded copy, no SDPA, no plain version."""
    from repro_torch.kernels import flash_attention as tfa
    d, dv = pair
    args, kw = _bwd_inputs(cuda, (1, 2, 2, 16, 16, d, True, None, None, 0),
                           dtype, dv)
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match=r"built \(D, Dv\) pairs.*\(96, 64\)"):
        tfa.flash_attention(*args[:3], **kw)
    with pytest.raises(ValueError, match=r"built \(D, Dv\) pairs"):
        tfa.flash_attention_bwd(*args, **kw)
    assert (tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == before


# zamba2-7b's head_dim 112 (its shared attention block), built in the
# square libraries (padded to 128 columns in the bf16 kernels' shared
# memory), in both dtypes: causal and not, GQA, windows, softcaps that the
# logits reach, shifted queries and rows with no key, and zamba2's 32/32
# heads at 1,000 tokens
HD112_CASES = [  # b, hq, hkv, sq, skv, (d, dv), causal, window, softcap, off
    (1, 4, 4, 100, 100, (112, 112), True, None, None, 0),
    (2, 4, 4, 64, 64, (112, 112), False, None, None, 0),
    (1, 8, 2, 70, 70, (112, 112), True, None, 2.0, 0),
    (1, 4, 1, 40, 64, (112, 112), True, 16, None, 24),
    (2, 4, 2, 33, 33, (112, 112), False, 8, 3.0, -5),
    (1, 8, 8, 300, 300, (112, 112), True, 128, 50.0, 0),
    (1, 32, 32, 1000, 1000, (112, 112), True, None, None, 0),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (BF16, 2e-2)])
@pytest.mark.parametrize("case", HD112_CASES, ids=str)
def test_flash_attention_hd112_matches_plain(cuda, monkeypatch, case, dtype,
                                             tol):
    """The forward at (112, 112) against the plain version: one launch of
    the square library of its dtype, the lse."""
    from repro_torch.kernels import flash_attention as tfa
    (q, k, v, _, want_lse, _), kw = _mla_args(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert called == [tfa.kernel_route(dtype)]
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) < tol
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, got)
    big = want_lse == tfa.BIG
    assert torch.equal(lse == tfa.BIG, big)
    scale = max(1.0, float(want_lse.masked_fill(big, 0.0).abs().max()))
    lse_tol = 1e-3 if dtype == BF16 else 1e-4
    assert float((lse - want_lse).abs().masked_fill(big, 0.0).max()) \
        <= lse_tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 2e-2)])
@pytest.mark.parametrize("case", HD112_CASES, ids=str)
def test_flash_attention_hd112_bwd_matches_plain(cuda, monkeypatch, case,
                                                 dtype, tol):
    """dq, dk and dv at (112, 112) against `_bwd_rule`'s port, each within
    ``tol`` of its largest |x|."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _mla_args(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    assert called == [tfa.bwd_kernel_route(dtype)]
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype, tol)


@pytest.mark.parametrize("dtype,tol,bwd_tol", [(torch.float32, 2e-5, 1e-4),
                                               (BF16, 2e-2, 2e-2)])
def test_flash_attention_hd112_strided_views(cuda, dtype, tol, bwd_tol):
    """[B, S, H, 112] activations viewed as [B, H, S, 112], as zamba2's
    shared block hands them over: the outputs and gradients keep the
    layouts; the bf16 backward gives the same bits twice."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, (2, 8, 8, 100, 100, 112, True, None, None,
                                  0), dtype)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             if t.dim() == 4 else t for t in args]
    out = tfa.flash_attention(*views[:3], **kw)
    assert out.stride() == views[0].stride()
    want = tfa.flash_attention_plain(*args[:3], **kw)
    assert float((out.float() - want.float()).abs().max()) < tol
    got = tfa.flash_attention_bwd(*views, **kw)
    for g, t in zip(got, views):
        assert g.stride() == t.stride()
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype,
               bwd_tol)
    again = tfa.flash_attention_bwd(*views, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_custom_ops_pass_opcheck(cuda, dtype):
    """The attention ops at minicpm3-4b's pair: the fake implementations
    give o and dv v's width, and each call launches its kernel."""
    from repro_torch.kernels import flash_attention as tfa
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, 0, 1, 4, 4, 64, 64, 96, dt, 64)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    for op, args in ((torch.ops.repro_torch.flash_attention,
                      (q, k, v, True, None, None, None, 128, 128, None,
                       True)),
                     (torch.ops.repro_torch.flash_attention_bwd,
                      (q, k, v, o, lse, torch.randn_like(o), True, None,
                       None, None, None))):
        before = (tfa.flash_attention.launches,
                  tfa.flash_attention_bwd.launches)
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)
        assert (tfa.flash_attention.launches,
                tfa.flash_attention_bwd.launches) != before


def test_card_mla_serve_equals_cpu_serve(cuda):
    """minicpm3-4b's smoke configuration served on the card (the MLA
    prefill through the (24, 16) kernel, the absorbed decode in plain
    PyTorch) gives the CPU's tokens, one launch a layer a wave."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("minicpm3_4b")
    cpu = Model(cfg).init(0, device="cpu")
    card = Model(cfg).load(tree_map(lambda t: t.to(cuda), cpu.params))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (21, 5, 21, 40, 21)]
    before = tfa.flash_attention.launches
    eng = ServeEngine(card, max_batch=2, max_seq=64)
    got = eng.serve(reqs, max_new=8)
    assert tfa.flash_attention.launches - before == (cfg.num_layers
                                                     * eng.stats.waves)
    assert got == ServeEngine(cpu, max_batch=2, max_seq=64).serve(
        reqs, max_new=8)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_16e",
                                  "deepseek_v2_lite_16b"])
def test_card_moe_serve_equals_cpu_serve(cuda, arch):
    """The MoE smoke configurations served on the card (the dense
    dispatch's sort, scatter and expert products on the card; deepseek's
    MLA prefill through the (24, 16) kernel) give the CPU's tokens, one
    attention launch a layer a wave."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config(arch)
    cpu = Model(cfg).init(0, device="cpu")
    card = Model(cfg).load(tree_map(lambda t: t.to(cuda), cpu.params))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (21, 5, 21, 40, 21)]
    before = tfa.flash_attention.launches
    eng = ServeEngine(card, max_batch=2, max_seq=64)
    got = eng.serve(reqs, max_new=8)
    assert tfa.flash_attention.launches - before == (cfg.num_layers
                                                     * eng.stats.waves)
    assert got == ServeEngine(cpu, max_batch=2, max_seq=64).serve(
        reqs, max_new=8)


# frontier shapes of maintenance: (lanes, num_sigs, padding lanes) —
# short batches, more rows than lanes (many empty segments), padding
# lanes with seg >= num_sigs, and one batch past a warp and a CTA tile
FRONTIER_CASES = [(1, 1, 0), (3, 40, 5), (37, 5, 3), (500, 2000, 12),
                  (4097, 300, 1023), (70000, 9000, 0)]


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("n,num_sigs,pad", FRONTIER_CASES)
def test_frontier_fold_matches_plain(cuda, n, num_sigs, pad, dedup):
    rng = np.random.default_rng(n + num_sigs)
    seg = np.concatenate([np.sort(rng.integers(0, num_sigs, n)),
                          num_sigs + rng.integers(0, 3, pad)])
    a = rng.integers(0, 3, n + pad) - 2 ** 31 + 5
    b = rng.integers(0, 4, n + pad) + 2 ** 31 - 7
    order = np.lexsort((b, a, seg))  # presorted: equal triples adjacent
    lanes = [torch.from_numpy(x[order].astype(np.int64).astype(np.int32))
             .to(cuda) for x in (a, b, seg)]
    lanes.append(torch.arange(n + pad, device=cuda) < n)
    before = tfold.sig_fold.launches
    got = tfold.frontier_sig_fold(*lanes, num_sigs=num_sigs, dedup=dedup)
    torch.cuda.synchronize()
    assert tfold.sig_fold.launches == before + 1
    want = tfold.sig_fold_plain(*lanes, nodes_per_block=num_sigs,
                                edges_per_block=n + pad, dedup=dedup,
                                presorted=True)
    assert torch.equal(got, want)


def _maintenance_stream(m, seed: int, steps: int = 6) -> None:
    """A seeded stream of edge inserts and deletes, node deletes, a
    compact and a Change-k (the draws depend only on the rng and the
    maintained graph)."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        n = m.backend.num_nodes
        if step % 3 == 0:
            cnt = int(rng.integers(1, 40))
            m.add_edges(rng.integers(0, n, cnt), rng.integers(0, 3, cnt),
                        rng.integers(0, n, cnt))
        elif step % 3 == 1:
            g = m.graph
            take = rng.integers(0, g.num_edges, 5)
            m.delete_edges(g.src[take], g.elabel[take], g.dst[take])
        else:
            m.delete_node(int(rng.integers(0, n)))
    m.compact()
    m.change_k(m.k + 1)


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_maintenance_equals_cpu(cuda, mode):
    """The same stream maintained with device propagation on the card
    (every frontier fold through the kernel) and on the CPU: equal pid
    histories, next_pid and stores."""
    from repro_torch.core import BisimMaintainer
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    card = BisimMaintainer(g, 4, mode=mode, device=cuda)
    before = tfold.sig_fold.launches
    _maintenance_stream(card, 7)
    assert tfold.sig_fold.launches > before
    cpu = BisimMaintainer(g, 4, mode=mode, device="cpu")
    _maintenance_stream(cpu, 7)
    assert card.k == cpu.k and list(card.next_pid) == list(cpu.next_pid)
    for j in range(card.k + 1):
        np.testing.assert_array_equal(card.pids[j], cpu.pids[j])
        assert card.stores[j].to_dict() == cpu.stores[j].to_dict()


def _ooc_state(m) -> tuple:
    """Pid files as they lie on disk, next_pid, tombstones, IOStats."""
    return ([np.load(p) for p in m.backend.pid_paths], list(m.next_pid),
            m._tombstone.copy(), m.backend.io.to_dict())


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_ooc_maintenance_equals_cpu(cuda, tmp_path, mode):
    """The same stream over the out-of-core backend on the card (builds
    through the chunk kernel, frontier folds through the flat kernel)
    with device and host propagation, and on the CPU: equal pid files,
    next_pid, tombstones, IOStats and stores."""
    from repro_torch.core import BisimMaintainer
    from repro_torch.exmem import OocBackend
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    runs = []
    for name, device, prop in (("card", cuda, True), ("card-host", cuda,
                                                      False),
                               ("cpu", "cpu", True)):
        chunks, folds = (tfold.chunk_sig_fold.launches,
                         tfold.sig_fold.launches)
        be = OocBackend(g, chunk_edges=4096, spill_threshold=1024,
                        workdir=str(tmp_path / name), io_threads=0,
                        device=device)
        m = BisimMaintainer(be, 4, mode=mode, device_propagation=prop)
        _maintenance_stream(m, 7)
        if name == "card":
            assert tfold.chunk_sig_fold.launches > chunks
            assert tfold.sig_fold.launches > folds
        for s in m.stores:
            s.flush()
        runs.append((_ooc_state(m), [s.state() for s in m.stores]))
        be.close()
    (want, want_stores) = runs[-1]
    for got, got_stores in runs[:-1]:
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        assert got[1:2] == want[1:2] and got[3] == want[3]
        np.testing.assert_array_equal(got[2], want[2])
        assert got_stores == want_stores


def test_card_ooc_recovery_equals_cpu(cuda, tmp_path):
    """A WAL'd stream on the card, snapshotted, continued, dropped without
    a close and restored with device propagation: the pre-crash pid files
    again, and the restored maintainer goes on as the CPU's does."""
    from repro_torch.core import BisimMaintainer
    from repro_torch.exmem import OocBackend
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=2)
    wd = str(tmp_path / "card")
    be = OocBackend(g, chunk_edges=4096, spill_threshold=1024, workdir=wd,
                    io_threads=0, wal=True, device=cuda)
    m = BisimMaintainer(be, 3, wal=True)
    _maintenance_stream(m, 3, steps=3)
    m.snapshot()
    _maintenance_stream(m, 4, steps=3)
    before = _ooc_state(m)
    be.aio.close()  # the crash: no close(), no snapshot
    be2, state = OocBackend.restore(wd, io_threads=0, device=cuda)
    m2 = BisimMaintainer.restore(be2, state)
    got = _ooc_state(m2)
    for a, b in zip(got[0], before[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == before[1]
    np.testing.assert_array_equal(got[2], before[2])
    cpu = BisimMaintainer(OocBackend(g, chunk_edges=4096,
                                     spill_threshold=1024,
                                     workdir=str(tmp_path / "cpu"),
                                     io_threads=0, device="cpu"), 3)
    _maintenance_stream(cpu, 3, steps=3)
    _maintenance_stream(cpu, 4, steps=3)
    for mm in (m2, cpu):
        _maintenance_stream(mm, 5, steps=3)
    for a, b in zip(_ooc_state(m2)[0], _ooc_state(cpu)[0]):
        np.testing.assert_array_equal(a, b)
    be2.close()
    cpu.backend.close()


def _quotient_queries(g, rng, k, n=24):
    """Random-walk label paths at every level, some with endpoint label
    constraints, and point lookups."""
    from repro_torch.quotient import LabelPath, PointLookup, ReachTemplate
    off, qs = g.out_offsets(), []
    while len(qs) < n:
        level = int(rng.integers(1, k + 1))
        hops = int(rng.integers(1, level + 1))
        cur, labs = int(rng.integers(g.num_nodes)), []
        for _ in range(hops):
            lo, hi = int(off[cur]), int(off[cur + 1])
            if hi == lo:
                break
            e = int(rng.integers(lo, hi))
            labs.append(int(g.elabel[e]))
            cur = int(g.dst[e])
        if len(labs) == hops:
            qs.append(LabelPath(tuple(labs), level=level) if len(qs) % 2
                      else ReachTemplate(tuple(labs), src_label=len(qs) % 4,
                                         tgt_label=1, level=level))
    qs += [PointLookup(int(x), k) for x in rng.integers(0, g.num_nodes, 4)]
    return qs


def _same_answers(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("hop_elems", [64, 1 << 26])
def test_quotient_engine_card_equals_cpu(cuda, tmp_path, monkeypatch,
                                         hop_elems):
    """The engine's waves on the card give the CPU engine's answers and
    stats, and `eval_ref`'s, before and after patches the service
    absorbs (frontier folds through the kernel), at any hop tiling."""
    from repro_torch.core import BisimMaintainer
    from repro_torch.quotient import (QuotientEngine, QuotientService,
                                      engine, eval_ref)
    monkeypatch.setattr(engine, "HOP_ELEMS", hop_elems)
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    rng = np.random.default_rng(5)
    m = BisimMaintainer(g, 4, device=cuda)
    svc = QuotientService(m, str(tmp_path), max_batch=8)
    assert svc.engine.device.type == "cuda"
    for step in range(3):
        queries = _quotient_queries(m.graph, rng, m.k)
        card = svc.query(queries)
        cpu = QuotientEngine(svc.index, max_batch=8, device="cpu")
        _same_answers(card, cpu.query(queries))
        _same_answers(card, [eval_ref(svc.index, q) for q in queries])
        n = m.backend.num_nodes
        before = tfold.sig_fold.launches
        svc.add_edges(rng.integers(0, n, 20), rng.integers(0, 3, 20),
                      rng.integers(0, n, 20))
        assert tfold.sig_fold.launches > before
        assert svc.patches == step + 1 and svc.engine.epoch == svc.epoch


def test_quotient_engine_one_transfer_a_wave(cuda, tmp_path):
    """A batch of path queries makes one device->host copy a wave."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import BisimMaintainer
    from repro_torch.quotient import QuotientService
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=2)
    m = BisimMaintainer(g, 4, device=cuda)
    svc = QuotientService(m, str(tmp_path), max_batch=4)
    queries = [q for q in _quotient_queries(g, np.random.default_rng(3), 4)
               if hasattr(q, "labels")]
    svc.query(queries)  # warm-up
    waves0 = svc.engine.stats["waves"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.query(queries)
        torch.cuda.synchronize()
    waves = svc.engine.stats["waves"] - waves0
    dtoh = sum(e.count for e in prof.key_averages() if "DtoH" in e.key)
    assert waves >= 3 and dtoh == waves


@pytest.mark.parametrize("ranking", ["allgather", "bucketed"])
@pytest.mark.parametrize("mode", ["sorted", "dedup_hash", "multiset"])
def test_card_distributed_one_rank_equals_cpu(cuda, mode, ranking):
    """A one-rank NCCL build on the card equals the one-rank gloo build on
    the CPU, and folds through ``fold_flat`` once an iteration."""
    import torch.distributed as dist
    from repro_torch.core import build_bisim_distributed
    from repro_torch.launch.cluster import init_cluster
    g = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    got = {}
    for device in ("cuda", "cpu"):
        assert init_cluster(device=device) == (0, 1)
        try:
            assert dist.get_backend() == ("nccl" if device == "cuda"
                                          else "gloo")
            before = tfold.sig_fold.launches
            res = build_bisim_distributed(g, 6, mode=mode, ranking=ranking,
                                          device=device)
            got[device] = res, tfold.sig_fold.launches - before
        finally:
            dist.destroy_process_group()
    (card, launches), (cpu, cpu_launches) = got["cuda"], got["cpu"]
    np.testing.assert_array_equal(card.pids, cpu.pids)
    assert card.counts == cpu.counts
    assert card.converged_at == cpu.converged_at
    assert launches == len(card.counts) - 1 > 0 and cpu_launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_custom_ops_launch_on_the_card_and_pass_opcheck(cuda, dtype):
    """The wrappers' custom ops on CUDA tensors: schema, fake
    implementation (the kernels' output layouts), autograd registration
    and AOT dispatch, each call launching its kernel."""
    from repro_torch.kernels import flash_attention as tfa
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 4, 64, 64, generator=g, device=cuda, dtype=dt)
    k, v = (torch.randn(1, 2, 64, 64, generator=g, device=cuda, dtype=dt)
            for _ in range(2))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, window=32)
    cases = [(torch.ops.repro_torch.flash_attention,
              (q, k, v, True, 32, None, None, 128, 128, None, True)),
             (torch.ops.repro_torch.flash_attention_bwd,
              (q, k, v, o, lse, torch.randn_like(o), True, 32, None, None,
               None))]
    if dtype == "float32":
        lanes = [x.to(cuda) for x in _lanes(3, 4096, 64)]
        cases.append((torch.ops.repro_torch.sig_fold,
                      (*lanes, 64, 4096, False, False)))
    for op, args in cases:
        before = (tfold.sig_fold.launches, tfa.flash_attention.launches,
                  tfa.flash_attention_bwd.launches)
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)
        after = (tfold.sig_fold.launches, tfa.flash_attention.launches,
                 tfa.flash_attention_bwd.launches)
        assert after != before, op


# non-causal calls with Sq > Skv (the encoder-decoder's cross-attention:
# decoder positions over frames), Sq = 1 (a decode step's query over the
# frames: one real row in the bf16 kernel's 128-row TMA tile), and the
# encoder's non-causal Sq = Skv; seamless-m4t's heads (16/16 of 64) at
# 4,096 frames among them, GQA, a softcap that the logits reach, the
# offset given and by default (Skv - Sq < 0)
CROSS_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset
    (2, 4, 4, 40, 24, 16, False, None, None, None),
    (4, 16, 16, 1, 4096, 64, False, None, None, None),
    (2, 4, 4, 1, 24, 16, False, None, None, None),
    (1, 8, 2, 1, 300, 64, False, None, None, 0),
    (1, 16, 16, 300, 128, 64, False, None, None, None),
    (2, 8, 2, 200, 70, 64, False, None, 2.0, 0),
    (1, 16, 16, 1000, 300, 64, False, None, None, None),
    (1, 4, 1, 129, 64, 128, False, None, None, None),
    (1, 16, 16, 512, 512, 64, False, None, None, None),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (BF16, 2e-2)])
@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
def test_flash_attention_cross_matches_plain(cuda, monkeypatch, case, dtype,
                                             tol):
    """The forward kernels at non-causal Sq > Skv, Sq = 1 and Sq = Skv
    against the plain version: one launch of the square library of the
    dtype; the lse against `_fwd_impl`'s port, the output with it equal
    to the output without."""
    from repro_torch.kernels import flash_attention as tfa
    (q, k, v, _, want_lse, _), kw = _bwd_inputs(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert called == [tfa.kernel_route(dtype)]
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) < tol
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, got)
    assert not bool((want_lse == tfa.BIG).any())  # every row sees a key
    lse_tol = 1e-3 if dtype == BF16 else 1e-4
    assert float((lse - want_lse).abs().max()) \
        <= lse_tol * max(1.0, float(want_lse.abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (BF16, 2e-2)])
@pytest.mark.parametrize("case", CROSS_CASES, ids=str)
def test_flash_attention_cross_bwd_matches_plain(cuda, monkeypatch, case,
                                                 dtype, tol):
    """The backward kernels at non-causal Sq > Skv, Sq = 1 and Sq = Skv
    against `_bwd_rule`'s port, each gradient within ``tol`` of its
    largest |x|."""
    from repro_torch.kernels import flash_attention as tfa
    args, kw = _bwd_inputs(cuda, case, dtype)
    called = _routes_called(monkeypatch)
    got = tfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert called == [tfa.bwd_kernel_route(dtype)]
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw), dtype, tol)


# f32 at every built (D, Dv) pair, non-causal: a decode step's Sq = 1 (the
# 3xTF32 forward's decode mode, Sq <= 16: one 16-row tile, its warps share
# out each kv tile's keys and combine their softmax states) and Sq > Skv
# (the 128-row tile, rows past Skv's tiles, keys zero-filled past Skv)
F32_EDGE_CASES = [  # b, hq, hkv, sq, skv, (d, dv)
    (b, hq, hkv, sq, skv, pair) for pair in HEAD_DIMS
    for b, hq, hkv, sq, skv in ((4, 8, 8, 1, 300), (1, 4, 2, 200, 70))]


@pytest.mark.parametrize("case", F32_EDGE_CASES, ids=str)
def test_flash_attention_f32_edge_rows_match_plain(cuda, monkeypatch, case):
    """The f32 forward (2e-5, its lse 1e-4) and backward (1e-4 of each
    gradient's max |x|) at Sq = 1 and non-causal Sq > Skv, at each pair's
    library."""
    from repro_torch.kernels import flash_attention as tfa
    b, hq, hkv, sq, skv, (d, dv) = case
    args, kw = _bwd_inputs(cuda, (b, hq, hkv, sq, skv, d, False, None, None,
                                  None), torch.float32, dv)
    q, k, v, _, want_lse, _ = args
    called = _routes_called(monkeypatch)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    got = tfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert called == [tfa.kernel_route(torch.float32, d, dv),
                      tfa.bwd_kernel_route(torch.float32, d, dv)]
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert o.shape == want.shape == (b, hq, sq, dv)
    assert float((o - want).abs().max()) < 2e-5
    assert float((lse - want_lse).abs().max()) \
        <= 1e-4 * max(1.0, float(want_lse.abs().max()))
    _bwd_close(got, tfa.flash_attention_bwd_plain(*args, **kw),
               torch.float32, 1e-4)


def test_causal_longer_queries_raise_on_card(cuda):
    """A causal call with Sq > Skv still raises; nothing launches."""
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = _qkv(cuda, 0, 1, 4, 4, 40, 24, 16, BF16)
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="exceeds"):
        tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention.launches == before


def test_card_encdec_serve_equals_cpu_serve(cuda):
    """The encoder-decoder's smoke configuration served on the card over
    the same stub frames gives the CPU's tokens; the kernel launches
    once an encoder layer and twice a decoder layer a prefill wave, once
    a decoder layer a decode step (its cross-attention)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model, encdec
    from repro_torch.models.params import tree_map
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("seamless_m4t_large_v2")
    cpu = Model(cfg).init(0, device="cpu")
    card = Model(cfg).load(tree_map(lambda t: t.to(cuda), cpu.params))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist()
            for n in (21, 40, 21, 40)]
    frames = torch.from_numpy(rng.normal(
        size=(2, cfg.source_len, cfg.d_model)).astype(np.float32))
    before = tfa.flash_attention.launches
    eng = ServeEngine(card, max_batch=2, max_seq=64)
    got = eng.serve(reqs, max_new=8, extra={"frames": frames.to(cuda)})
    st = eng.stats
    assert tfa.flash_attention.launches - before == (
        encdec.prefill_launches(cfg) * st.waves
        + encdec.decode_launches(cfg) * st.decode_steps)
    assert got == ServeEngine(cpu, max_batch=2, max_seq=64).serve(
        reqs, max_new=8, extra={"frames": frames})


# The pinned upload ring (`core/staging.py`): slots of 4 KiB, so small
# columns run many chunks through few slots.  Each upload queues behind a
# sleeping kernel, so every DMA waits on the stream: a slot the host
# refilled before its copy had run would show in the result.
STAGE_SLOT = 4096
SLEEP_CYCLES = 50_000_000


def _small_ring(monkeypatch, engage=True):
    from repro_torch.core import staging
    monkeypatch.setattr(staging, "SLOT_BYTES", STAGE_SLOT)
    monkeypatch.setattr(staging, "ENGAGE_SLOTS", 0 if engage else 1 << 40)
    return staging


@pytest.mark.parametrize("case", sorted(column_cases(1)))
def test_staged_upload_equals_direct_copy(cuda, monkeypatch, case):
    staging = _small_ring(monkeypatch)
    per = STAGE_SLOT // 4
    columns = column_cases(per)[case]()
    torch.cuda._sleep(SLEEP_CYCLES)
    staged, chunks = staging.upload(columns, cuda)
    assert chunks == sum(-(-len(x) // per) for x in columns)
    assert chunks > 0
    for x, t in zip(columns, staged):
        want = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
        assert t.device.type == "cuda" and t.dtype == want.dtype
        assert torch.equal(t, want)


def test_back_to_back_staged_builds_equal_direct_builds(cuda, monkeypatch):
    """Two graphs of one size, each built with its columns staged right
    after the other's: each gives the pid history, counts and stores of
    its own direct upload."""
    from repro_torch import obs
    from repro_torch.graph.storage import Graph
    g1 = gen.powerlaw_graph(3000, 15000, 4, 3, seed=1)
    rng = np.random.default_rng(2)
    g2 = Graph(rng.integers(0, 4, g1.num_nodes), g1.src, g1.dst, g1.elabel)
    _small_ring(monkeypatch, engage=False)
    direct = [build_bisim(g, 6, with_store=True, device=cuda)
              for g in (g1, g2)]
    assert direct[0].pids.tobytes() != direct[1].pids.tobytes()
    _small_ring(monkeypatch, engage=True)
    with obs.tracing() as tracer:
        staged = []
        for g in (g1, g2):
            torch.cuda._sleep(SLEEP_CYCLES)
            staged.append(build_bisim(g, 6, with_store=True, device=cuda))
    ups = tracer.find("build.upload")
    assert [u["attrs"]["staged_chunks"] for u in ups] == [
        sum(-(-x.nbytes // STAGE_SLOT) for x in (
            g.node_labels, g.src, g.dst, g.elabel)) for g in (g1, g2)]
    for d, s in zip(direct, staged):
        np.testing.assert_array_equal(d.pids, s.pids)
        assert d.counts == s.counts and d.next_pid == s.next_pid
        for a, b in zip(d.stores, s.stores):
            np.testing.assert_array_equal(a.keys, b.keys)
            np.testing.assert_array_equal(a.pids, b.pids)
