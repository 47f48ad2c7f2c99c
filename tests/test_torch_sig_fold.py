"""The port's `sig_fold` vs the Pallas `sig_fold` / `frontier_sig_fold`.

On CPU tensors the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as the JAX package's own kernel tests run
it.  Outputs are u32 lanes, compared exactly.  The kernel itself is
held against the plain version on the card by `test_torch_kernels_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.graph import generators as gen
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sig_fold as jfold

torch = pytest.importorskip("torch")
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy().astype(np.uint32),
                                      np.asarray(w))
        assert g.dtype == torch.int64


def _lanes(seed, n, nb, nlab, npid, *, sort_eb=None, big=False):
    """Random fold lanes: local_src in [-1, nb + 2), some invalid; with
    ``sort_eb`` sorted by triple within each block; with ``big`` u32 values
    >= 2^31 in eLabel and pId."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-1, nb + 2, n)
    a = rng.integers(0, nlab, n)
    b = rng.integers(0, npid, n)
    if big:
        a, b = a - 2 ** 31 + 5, b + 2 ** 31 - 7
    if sort_eb:
        order = np.lexsort((b, a, s, np.arange(n) // sort_eb))
        s, a, b = s[order], a[order], b[order]
    valid = rng.random(n) < 0.85
    return [a.astype(np.int64).astype(np.int32),
            b.astype(np.int64).astype(np.int32), s.astype(np.int32), valid]


def _both(lanes, **kw):
    got = tfold.sig_fold(*(torch.from_numpy(x) for x in lanes), **kw)
    want = jfold.sig_fold(*(jnp.asarray(x) for x in lanes), **kw)
    return got, want


@pytest.mark.parametrize("n,e,nb,align", [
    (64, 200, 8, 32), (100, 400, 8, 128), (33, 77, 4, 16), (256, 1024, 16, 64),
])
def test_layout_fold_matches_pallas(n, e, nb, align):
    g = gen.random_graph(n, e, 3, 2, seed=n + e)
    lay = ops.blocked_csr_layout(g.src, g.dst, g.elabel, g.num_nodes,
                                 nodes_per_block=nb, edges_per_block_align=align)
    jlay = jops.blocked_csr_layout(g.src, g.dst, g.elabel, g.num_nodes,
                                   nodes_per_block=nb,
                                   edges_per_block_align=align)
    for key in ("elabel", "dst", "local_src", "valid"):
        np.testing.assert_array_equal(lay[key], jlay[key])
    pid_prev = np.arange(n, dtype=np.int32) % 11
    meta = dict(nodes_per_block=nb, edges_per_block=lay["edges_per_block"],
                num_nodes=n)
    cols = ("elabel", "dst", "local_src", "valid")
    got = ops.sig_fold_from_layout(
        *(torch.from_numpy(lay[c]) for c in cols),
        torch.from_numpy(pid_prev), **meta)
    want = jops.sig_fold_from_layout(
        *(jnp.asarray(lay[c]) for c in cols), jnp.asarray(pid_prev), **meta)
    _eq(got, want)
    # and the port's plain oracle agrees with the JAX one
    args = (g.elabel, pid_prev[g.dst], g.src, np.ones(g.num_edges, bool))
    _eq(ref.sig_fold_ref(*(torch.from_numpy(x) for x in args), n),
        jref.sig_fold_ref(*(jnp.asarray(x) for x in args), n))


def test_empty_blocks_are_identity():
    src = np.array([0, 0, 31], np.int32)
    lay = ops.blocked_csr_layout(src, np.array([1, 2, 3], np.int32),
                                 np.zeros(3, np.int32), 32,
                                 nodes_per_block=8, edges_per_block_align=8)
    lanes = [lay["elabel"], np.arange(lay["dst"].size, dtype=np.int32),
             lay["local_src"], lay["valid"]]
    got, want = _both(lanes, nodes_per_block=8,
                      edges_per_block=lay["edges_per_block"])
    _eq(got, want)
    hi = got[0].numpy()
    assert (hi[1:31] == 0).all() and hi[0] != 0 and hi[31] != 0


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dedup,presorted", [
    (False, False), (True, True), (True, False)])
def test_fold_modes_match_pallas(dedup, presorted, big):
    eb, nb = 256, 16
    lanes = _lanes(int(dedup) + 2 * int(presorted) + 4 * big, 4 * eb, nb,
                   3, 6, sort_eb=eb if presorted else None, big=big)
    got, want = _both(lanes, nodes_per_block=nb, edges_per_block=eb,
                      dedup=dedup, presorted=presorted)
    _eq(got, want)


def test_presorted_dedup_is_positional():
    """presorted=True drops only *adjacent* equal triples (the promise is
    the caller's): an unsorted block keeps its separated duplicates, as
    the Pallas kernel does."""
    lanes = _lanes(7, 512, 8, 2, 3)
    got, want = _both(lanes, nodes_per_block=8, edges_per_block=128,
                      dedup=True, presorted=True)
    _eq(got, want)


@pytest.mark.parametrize("presorted", [True, False])
def test_dedup_never_spans_blocks(presorted):
    """Each block's first lane starts afresh: identical blocks of one
    repeated triple keep one lane each, not one in all."""
    n, eb = 16, 4
    lanes = [np.full(n, 2, np.int32), np.full(n, 9, np.int32),
             np.zeros(n, np.int32), np.ones(n, bool)]
    got, want = _both(lanes, nodes_per_block=2, edges_per_block=eb,
                      dedup=True, presorted=presorted)
    _eq(got, want)
    hi = got[0].numpy()
    assert (hi[0::2] == hi[0]).all() and hi[0] != 0 and (hi[1::2] == 0).all()


@pytest.mark.parametrize("dedup", [False, True])
def test_frontier_fold_padded_segs(dedup):
    """One block; padded seg >= num_sigs match no row."""
    rng = np.random.default_rng(4)
    ns, ne = 16, 64
    seg = np.sort(rng.integers(0, ns + 3, ne)).astype(np.int32)
    lab = rng.integers(0, 4, ne).astype(np.int32)
    tgt = rng.integers(0, 30, ne).astype(np.int32)
    valid = rng.random(ne) < 0.8
    if dedup:  # the set-semantics caller lexsorts first
        order = np.lexsort((tgt, lab, seg))
        seg, lab, tgt, valid = seg[order], lab[order], tgt[order], \
            valid[order]
    cols = (lab, tgt, seg, valid)
    got = tfold.frontier_sig_fold(*(torch.from_numpy(x) for x in cols),
                                  num_sigs=ns, dedup=dedup)
    want = jfold.frontier_sig_fold(*(jnp.asarray(x) for x in cols),
                                   num_sigs=ns, dedup=dedup)
    _eq(got, want)


def test_frontier_fold_empty_batch_launches_nothing():
    e = torch.zeros(0, dtype=torch.int32)
    before = tfold.sig_fold.launches
    hi, lo = tfold.frontier_sig_fold(e, e, e, e.bool(), num_sigs=5)
    assert hi.tolist() == [0] * 5 and lo.tolist() == [0] * 5
    assert tfold.sig_fold.launches == before


def test_edge_hash_matches_core():
    e = np.arange(100, dtype=np.int32) % 5
    p = (np.arange(100, dtype=np.int32) * 7) % 23
    _eq(ops.edge_hash(torch.from_numpy(e), torch.from_numpy(p)),
        jops.edge_hash(jnp.asarray(e), jnp.asarray(p)))
    _eq(ref.edge_hash_ref(torch.from_numpy(e), torch.from_numpy(p)),
        jref.edge_hash_ref(jnp.asarray(e), jnp.asarray(p)))


@pytest.mark.parametrize("bad", ["dtype", "eb", "pow2", "nb"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    lanes = [torch.from_numpy(x) for x in _lanes(0, 256, 8, 2, 3)]
    kw = dict(nodes_per_block=8, edges_per_block=64)
    if bad == "dtype":
        lanes[1] = lanes[1].to(torch.int64)
    elif bad == "eb":
        kw["edges_per_block"] = 100
    elif bad == "pow2":
        lanes = [x[:192] for x in lanes]
        kw.update(edges_per_block=96, dedup=True)
    else:
        kw["nodes_per_block"] = 0
    with pytest.raises(ValueError, match="sig_fold"):
        tfold.sig_fold(*lanes, **kw)


def test_wrapper_raises_on_other_devices():
    lanes = [torch.from_numpy(x).to("meta") for x in _lanes(0, 64, 8, 2, 3)]
    with pytest.raises(ValueError, match="no kernel for device"):
        tfold.sig_fold(*lanes, nodes_per_block=8, edges_per_block=64)
