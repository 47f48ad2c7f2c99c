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
