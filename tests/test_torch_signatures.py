"""The port's hash layer and signature fold vs the JAX package, exactly.

Every output is an integer, so every comparison is exact equality.
Inputs are made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashes_np
from repro.core import signatures as jsig
from repro.graph import generators as gen

torch = pytest.importorskip("torch")
from repro_torch.core import signatures as tsig  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]


def _lanes(seed, n=4096):
    """int32 columns spanning negatives, zero and values near 2^32 as u32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    x[:8] = [0, 1, -1, -2, 2 ** 31 - 1, -2 ** 31, 7, -7]
    return x


def _u32(t):
    """Port lanes (u32 in int64) as numpy uint32, checking their range."""
    a = t.numpy()
    assert a.min(initial=0) >= 0 and a.max(initial=0) < 2 ** 32
    return a.astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_lanes_match_reference(seed):
    a, b, c = _lanes(seed), _lanes(seed + 10), _lanes(seed + 20)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    np.testing.assert_array_equal(_u32(tsig.fmix32(ta)),
                                  np.asarray(jsig.fmix32(jnp.asarray(a))))
    np.testing.assert_array_equal(_u32(tsig.fmix32(ta)), hashes_np.fmix32(a))
    for got, want, want_np in zip(
            tsig.hash_pair(ta, tb), jsig.hash_pair(jnp.asarray(a),
                                                   jnp.asarray(b)),
            hashes_np.hash_pair(a, b)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
        np.testing.assert_array_equal(_u32(got), want_np)
    for got, want, want_np in zip(
            tsig.hash_triple(ta, tb, tc),
            jsig.hash_triple(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)),
            hashes_np.hash_triple(a, b, c)):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
        np.testing.assert_array_equal(_u32(got), want_np)


def test_hash_accepts_u32_lanes_in_int64():
    """Lanes already carried as u32-in-int64 (values near 2^32) hash like
    their int32 reinterpretation."""
    a = _lanes(5)
    wide = torch.from_numpy(a.astype(np.int64) & 0xFFFFFFFF)
    for x, y in zip(tsig.hash_pair(wide, wide),
                    tsig.hash_pair(torch.from_numpy(a), torch.from_numpy(a))):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_rank_pairs_unsigned_order(seed):
    """hi >= 2^31 must rank after hi < 2^31, as the reference's unsigned
    (hi, lo) lexsort ranks it."""
    rng = np.random.default_rng(seed)
    pool_hi = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    hi = rng.choice(pool_hi, 500)
    lo = rng.choice(np.array([0, 5, 2 ** 31, 2 ** 32 - 2], np.uint32), 500)
    want_pid, want_n = jsig.dense_rank_pairs(jnp.asarray(hi), jnp.asarray(lo))
    pid, count = tsig.dense_rank_pairs(torch.from_numpy(hi.astype(np.int64)),
                                       torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(want_pid))
    assert int(count) == int(want_n)
    assert pid.dtype == torch.int32


def test_dense_rank_ints_signed_order():
    x = _lanes(3, 300) % 17 - 8  # negative labels included
    want_pid, want_n = jsig.dense_rank_ints(jnp.asarray(x))
    pid, count = tsig.dense_rank_ints(torch.from_numpy(x))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(want_pid))
    assert int(count) == int(want_n)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_wrapsum_matches_reference(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** 32, 700, dtype=np.uint64).astype(np.uint32)
    cuts = np.sort(rng.integers(0, 701, 40))
    bounds = np.concatenate([[0], cuts, [700]]).astype(np.int32)
    want = jsig.segment_wrapsum(jnp.asarray(vals), jnp.asarray(bounds))
    got = tsig.segment_wrapsum(torch.from_numpy(vals.astype(np.int64)),
                               torch.from_numpy(bounds))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


GRAPHS = {
    "random": lambda: gen.random_graph(150, 600, 4, 3, seed=3),
    "powerlaw": lambda: gen.powerlaw_graph(200, 900, 3, 2, seed=4),
}


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("mode", MODES)
def test_signature_hashes_match_reference(gname, mode):
    g = GRAPHS[gname]()
    n = g.num_nodes
    rng = np.random.default_rng(9)
    pid0 = rng.integers(0, 4, n).astype(np.int32)
    pid_prev = rng.integers(0, 30, n).astype(np.int32)
    want = jsig.signature_hashes(
        jnp.asarray(pid0), jnp.asarray(g.src), jnp.asarray(g.dst),
        jnp.asarray(g.elabel), jnp.asarray(pid_prev), num_nodes=n, mode=mode)
    # the port takes edges in any order: shuffle them
    perm = rng.permutation(g.num_edges)
    cols = [torch.from_numpy(np.ascontiguousarray(x[perm]))
            for x in (g.src, g.dst, g.elabel)]
    got = tsig.signature_hashes(torch.from_numpy(pid0), *cols,
                                torch.from_numpy(pid_prev), num_nodes=n,
                                mode=mode)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_u32(x), np.asarray(y))


@pytest.mark.parametrize("mode", ["sorted", "dedup_hash"])
def test_signature_hashes_wide_labels(mode):
    """Labels spanning all of int32 on 2^16+ nodes do not fit the fused
    sort key: the two-sort route must give the same bits."""
    rng = np.random.default_rng(1)
    n, e = 70_000, 600
    src = rng.integers(0, 50, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    lab = rng.choice(np.array([-2 ** 31, -3, 0, 2 ** 31 - 1], np.int32), e)
    src, dst, lab = (np.concatenate([x, x[:100]]) for x in (src, dst, lab))
    pid0 = np.zeros(n, np.int32)
    pid_prev = rng.integers(0, n, n).astype(np.int32)
    want = jsig.signature_hashes(
        jnp.asarray(pid0), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(lab), jnp.asarray(pid_prev), num_nodes=n, mode=mode)
    got = tsig.signature_hashes(*(torch.from_numpy(x) for x in (
        pid0, src, dst, lab, pid_prev)), num_nodes=n, mode=mode)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_u32(x), np.asarray(y))


@pytest.mark.parametrize("num_nodes,elabel_range", [
    (300, (-5, 9)),                       # one fused int64 key
    (1 << 20, (-2 ** 31, 2 ** 31 - 1)),   # two stable sorts
])
def test_sort_triples_groups_equal_triples(num_nodes, elabel_range):
    rng = np.random.default_rng(2)
    e = 2000
    s = rng.integers(0, 40, e).astype(np.int32)
    a = rng.integers(-5, 10, e).astype(np.int32)
    b = rng.integers(0, 30, e).astype(np.int32)
    got = tsig._sort_triples(*(torch.from_numpy(x) for x in (s, a, b)),
                             num_nodes=num_nodes, elabel_range=elabel_range)
    trip = np.stack([x.numpy() for x in got], 1)
    # a permutation of the input in which equal triples are contiguous
    np.testing.assert_array_equal(np.sort(trip.view("i4,i4,i4"), axis=0),
                                  np.sort(np.stack([s, a, b], 1)
                                          .view("i4,i4,i4"), axis=0))
    starts = np.ones(e, bool)
    starts[1:] = (trip[1:] != trip[:-1]).any(1)
    assert starts.sum() == np.unique(trip, axis=0).shape[0]


def test_unknown_mode_raises():
    t = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown signature mode"):
        tsig.signature_hashes(t, t, t, t, t, num_nodes=3, mode="bogus")
