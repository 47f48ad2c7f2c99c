"""The port's `chunk_sig_fold` vs the Pallas `chunk_sig_fold` and the JAX
package's jnp arrangement of the same fold.

On CPU tensors the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as the JAX package's own kernel tests run
it, and the jnp route is the host keep mask plus
`repro.exmem.build._fold_chunk` — the oracle the out-of-core build names.
Outputs are u32 lanes, compared exactly.  The kernel itself is held
against the plain version on the card by `test_torch_kernels_gpu.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.exmem.build import _fold_chunk
from repro.kernels import sig_fold as jfold

torch = pytest.importorskip("torch")
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402


def _chunk(seed, n, chunk_edges, *, big=False, hub=False):
    """One chunk of a (src, eLabel, pId)-sorted stream, laid out as the
    out-of-core build lays it out: ``n`` real lanes with dense ascending
    ``seg``, padded to ``chunk_edges`` with seg = chunk_edges - 1.  Small
    label and pid ranges give duplicate triples; ``big`` puts u32 values
    >= 2^31 in eLabel and pId; ``hub`` gives every lane one source."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n, np.int64) if hub else rng.integers(0, n // 3 + 1, n)
    a = rng.integers(0, 3, n)
    b = rng.integers(0, 5, n)
    if big:
        a, b = a - 2 ** 31 + 5, b + 2 ** 31 - 7
    order = np.lexsort((b, a, src))
    src, a, b = src[order], a[order], b[order]
    new_src = np.ones(n, bool)
    new_src[1:] = src[1:] != src[:-1]
    lanes = np.zeros((3, chunk_edges), np.int32)
    lanes[0, :n] = a.astype(np.int64).astype(np.int32)
    lanes[1, :n] = b.astype(np.int64).astype(np.int32)
    lanes[2, :n] = np.cumsum(new_src) - 1
    lanes[2, n:] = chunk_edges - 1
    valid = np.arange(chunk_edges) < n
    return lanes, valid, src.astype(np.int32), int(new_src.sum())


def _host_keep(lanes, src, n, keep0, dedup):
    """The JAX package's host keep mask (exmem/build.py, jnp route)."""
    chunk_edges = lanes.shape[1]
    lab, pid = lanes[0], lanes[1]
    keep = np.ones(chunk_edges, dtype=bool)
    keep[n:] = False
    if dedup and n:
        keep[1:n] = ((src[1:] != src[:-1]) | (lab[1:n] != lab[:n - 1])
                     | (pid[1:n] != pid[:n - 1]))
        keep[0] = keep0
    return keep


def _eq(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))


@pytest.mark.parametrize("n,chunk_edges,big,hub", [
    (1000, 1024, False, False),   # partial chunk with padding
    (1024, 1024, False, False),   # full chunk
    (900, 1024, True, False),     # eLabel/pId >= 2^31 as u32
    (700, 1024, True, True),      # one hub segment
    (256, 256, False, True),      # full chunk, one segment
    (0, 256, False, False),       # all-invalid chunk
])
@pytest.mark.parametrize("dedup,keep0", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_chunk_fold_matches_reference(n, chunk_edges, big, hub, dedup,
                                      keep0):
    lanes, valid, src, _ = _chunk(n + 7 * big + 3 * hub, n, chunk_edges,
                                  big=big, hub=hub)
    got = tfold.chunk_sig_fold(*(torch.from_numpy(x) for x in lanes),
                               torch.from_numpy(valid), keep0,
                               num_segments=chunk_edges, dedup=dedup)
    assert tfold.chunk_sig_fold.launches == 0  # the CPU takes the plain route
    pallas = jfold.chunk_sig_fold(
        *(jnp.asarray(x) for x in lanes), jnp.asarray(valid),
        jnp.asarray([keep0]), num_segments=chunk_edges, dedup=dedup,
        interpret=True)
    _eq(got, pallas)
    keep = _host_keep(lanes, src, n, keep0, dedup)
    _eq(got, _fold_chunk(jnp.asarray(lanes[0]), jnp.asarray(lanes[1]),
                         jnp.asarray(lanes[2]), jnp.asarray(keep),
                         num_segments=chunk_edges))
    _eq(ref.chunk_fold_ref(*(torch.from_numpy(x[:n])
                             for x in (lanes[0], lanes[1], src)), n, keep0,
                           chunk_edges=chunk_edges, dedup=dedup), pallas)


@pytest.mark.parametrize("dedup", [True, False])
def test_chunk_fold_drops_segments_out_of_range(dedup):
    """With num_segments = the chunk's real segment count the padding
    (seg = chunk_edges - 1) matches no row; the rows equal the first
    num_segments of the full fold, as in the reference's boundary search."""
    lanes, valid, _, u = _chunk(11, 500, 512)
    t = [torch.from_numpy(x) for x in (*lanes, valid)]
    got = tfold.chunk_sig_fold(*t, True, num_segments=u, dedup=dedup)
    full = tfold.chunk_sig_fold(*t, True, num_segments=512, dedup=dedup)
    pallas = jfold.chunk_sig_fold(
        *(jnp.asarray(x) for x in (*lanes, valid)), jnp.asarray([True]),
        num_segments=u, dedup=dedup, interpret=True)
    _eq(got, pallas)
    for g, f in zip(got, full):
        assert torch.equal(g, f[:u])


def test_chunk_fold_rejects_bad_lanes():
    lanes, valid, _, _ = _chunk(0, 64, 64)
    t = [torch.from_numpy(x) for x in lanes]
    with pytest.raises(ValueError, match="seg must be"):
        tfold.chunk_sig_fold(t[0], t[1], t[2].to(torch.int64),
                             torch.from_numpy(valid), True, num_segments=64)
    with pytest.raises(ValueError, match="num_segments"):
        tfold.chunk_sig_fold(*t, torch.from_numpy(valid), True,
                             num_segments=-1)
