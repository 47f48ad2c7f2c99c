"""The port's device maintenance primitives (`repro_torch.core.
device_maint` and the frontier folds of `repro_torch.core.signatures`)
against the JAX package's, on the CPU.

Every output is integers, so the bar is equality: the frontier folds
against `repro.core.signatures` (its jnp route and its Pallas kernel in
interpret mode) and against `hashes_np.signatures_from_edges`; the
fused store resolve against the reference's `DeviceSigStore`, the port's
own staged path and `SigStore.get_or_assign`, pid for pid and entry for
entry.  On the CPU every fold takes the kernel's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.device_maint as rdm
from repro.core import hashes_np as ref_hashes_np
from repro.core import signatures as rsig
from repro.core.sig_store import SigStore as RefSigStore

torch = pytest.importorskip("torch")
import repro_torch.core.device_maint as dm  # noqa: E402
from repro_torch.core import hashes_np, signatures as sig  # noqa: E402
from repro_torch.core.device_maint import DeviceSigStore, bucket  # noqa: E402
from repro_torch.core.sig_store import (SigStore, keys_to_lanes,  # noqa: E402
                                        lanes_to_keys)
from repro_torch.kernels import sig_fold as tfold  # noqa: E402

CPU = torch.device("cpu")
MODES = ["sorted", "dedup_hash", "multiset"]
ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


# --------------------------------------------------------------- bucket
def test_bucket_floor_and_waste():
    """The cases of tests/test_fused_build.py's bucket policy, against
    the reference's `bucket` too."""
    assert bucket(0) == dm.BUCKET_FLOOR == rdm.BUCKET_FLOOR
    assert bucket(1) == dm.BUCKET_FLOOR
    assert bucket(dm.BUCKET_FLOOR) == dm.BUCKET_FLOOR
    for n in [0, 1, 7, 8, 9, 17, 100, 1000, 4097, 65537]:
        b = bucket(n)
        assert b == rdm.bucket(n)
        assert b >= n and (b & (b - 1)) == 0
        if n >= dm.BUCKET_FLOOR:
            assert b < 2 * n, f"bucket({n})={b} wastes >= 2x"
    assert bucket(3, floor=1) == 4
    assert bucket(0, floor=64) == 64
    for bad in (3, 0):
        with pytest.raises(ValueError, match="power of two"):
            bucket(10, floor=bad)


def test_key_lanes_keep_unsigned_order():
    """The device's int64 key orders like the store's u64 key, and the
    all-ones key is the sentinel."""
    rng = np.random.default_rng(1)
    keys = np.concatenate([rng.integers(0, 2**63, 200, dtype=np.uint64)
                           | (rng.integers(0, 2, 200).astype(np.uint64)
                              << np.uint64(63)),
                           [np.uint64(0), ALL_ONES, np.uint64(1 << 63)]])
    lanes = keys_to_lanes(keys)
    np.testing.assert_array_equal(np.argsort(lanes, kind="stable"),
                                  np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(lanes_to_keys(lanes), keys)
    assert lanes[-2] == dm._SENT
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    np.testing.assert_array_equal(sig.fuse_u32_pair(hi, lo).numpy(), lanes)


# ------------------------------------------------------- frontier folds
def _batch(rng, *, ns, ne, pad, big=False):
    """A gathered frontier batch: ascending seg with empty segments,
    duplicate triples, ``pad`` padding lanes (seg = ns) past ``ne``."""
    seg = np.sort(rng.integers(0, ns, ne))
    lab = rng.integers(0, 3, ne)
    tgt = rng.integers(0, 12, ne)
    if big:  # u32 values >= 2^31
        lab, tgt = lab + 2**31 + 5, tgt + 2**32 - 20
    p0 = rng.integers(0, 8, ns)
    bounds = np.searchsorted(seg, np.arange(ns + 1))
    total = ne + pad
    cols = [np.zeros(total, np.int64) for _ in range(3)]
    cols[0][:ne], cols[1][:ne], cols[2][:ne] = seg, lab, tgt
    cols[0][ne:] = ns
    return p0, seg, lab, tgt, bounds, cols


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_frontier_signature_hashes_match_reference(mode, big):
    """Both frontier folds against the reference's jnp route and against
    the numpy fold, with padding lanes and empty segments."""
    rng = np.random.default_rng(5 + big)
    dedup = mode != "multiset"
    for ns, ne, pad in ((1, 0, 3), (9, 40, 5), (23, 0, 8), (16, 90, 38),
                        (5, 64, 0)):
        p0, seg, lab, tgt, bounds, cols = _batch(rng, ns=ns, ne=ne, pad=pad,
                                                  big=big)
        want = ref_hashes_np.signatures_from_edges(p0, seg, lab, tgt, ns,
                                                   dedup=dedup)
        np.testing.assert_array_equal(hashes_np.signatures_from_edges(
            p0, seg, lab, tgt, ns, dedup=dedup), want)
        t = [torch.from_numpy(c.astype(np.uint32).astype(np.int32))
             for c in cols]
        p0_t = torch.from_numpy(p0)
        got = sig.frontier_signature_hashes(
            p0_t, t[0], t[1], t[2], ne, num_sigs=ns, dedup=dedup)
        ref = rsig.frontier_signature_hashes(
            jnp.asarray(p0.astype(np.uint32)),
            jnp.asarray(cols[0].astype(np.int32)),
            jnp.asarray(cols[1].astype(np.uint32)),
            jnp.asarray(cols[2].astype(np.uint32)),
            jnp.asarray(bounds.astype(np.int32)), jnp.int32(ne),
            num_sigs=ns, dedup=dedup)
        for g, r, w in zip(got, ref, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            np.testing.assert_array_equal(g.numpy(), w)
        if not dedup or pad == 0:
            # the presorted form folds deduplicated or multiset batches
            survivors = (np.unique(np.stack([seg, lab, tgt]), axis=1)
                         if dedup else np.stack([seg, lab, tgt]))
            sbounds = np.searchsorted(survivors[0], np.arange(ns + 1))
            e = survivors.shape[1]
            pres = sig.frontier_signature_hashes_presorted(
                p0_t, torch.from_numpy(survivors[1].astype(np.uint32)
                                       .astype(np.int32)),
                torch.from_numpy(survivors[2].astype(np.uint32)
                                 .astype(np.int32)),
                torch.from_numpy(sbounds), e, num_sigs=ns)
            for g, w in zip(pres, want):
                np.testing.assert_array_equal(g.numpy(), w)
    assert tfold.sig_fold.launches == 0  # the CPU takes the plain route


@pytest.mark.parametrize("dedup", [True, False])
def test_frontier_fold_matches_reference_kernel_route(dedup):
    """The reference's Pallas route (``use_kernel``, interpret mode) and
    the port's fold agree on one padded batch."""
    rng = np.random.default_rng(17)
    ns, ne, pad = 12, 50, 14
    p0, seg, lab, tgt, bounds, cols = _batch(rng, ns=ns, ne=ne, pad=pad)
    ref = rsig.frontier_signature_hashes(
        jnp.asarray(p0.astype(np.uint32)),
        jnp.asarray(cols[0].astype(np.int32)),
        jnp.asarray(cols[1].astype(np.uint32)),
        jnp.asarray(cols[2].astype(np.uint32)),
        jnp.asarray(bounds.astype(np.int32)), jnp.int32(ne), num_sigs=ns,
        dedup=dedup, use_kernel=True)
    got = dm.frontier_fold(p0, seg, lab, tgt, ns, dedup=dedup, device=CPU)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:ns])


@pytest.mark.parametrize("with_bounds", [False, True])
def test_frontier_fold_bitparity_random_batches(with_bounds):
    """`frontier_fold` == numpy fold == the reference's `frontier_fold`
    over random gathered batches (empty segments, duplicate triples,
    both dedup settings)."""
    rng = np.random.default_rng(7)
    for dedup in (True, False):
        for _ in range(6):
            ns = int(rng.integers(1, 24))
            ne = int(rng.integers(0, 90))
            seg = np.sort(rng.integers(0, ns, ne)).astype(np.int64)
            lab = rng.integers(0, 3, ne).astype(np.int32)
            tgt = rng.integers(0, 12, ne).astype(np.int64)
            p0 = rng.integers(0, 8, ns).astype(np.int64)
            bounds = (np.searchsorted(seg, np.arange(ns + 1))
                      if with_bounds else None)
            hh, hl = hashes_np.signatures_from_edges(p0, seg, lab, tgt, ns,
                                                     dedup=dedup)
            rh, rl = rdm.frontier_fold(p0, seg, lab, tgt, ns, dedup=dedup,
                                       bounds=bounds)
            dh, dl = dm.frontier_fold(p0, seg, lab, tgt, ns, dedup=dedup,
                                      bounds=bounds, device=CPU)
            np.testing.assert_array_equal(dh.numpy(), hh)
            np.testing.assert_array_equal(dl.numpy(), hl)
            np.testing.assert_array_equal(dh.numpy(), np.asarray(rh)[:ns])
            np.testing.assert_array_equal(dl.numpy(), np.asarray(rl)[:ns])


def test_frontier_fold_rejects_unsorted_seg():
    with pytest.raises(ValueError, match="ascending"):
        dm.frontier_fold(np.zeros(3), np.array([2, 0, 1]), np.zeros(3),
                         np.zeros(3), 3, device=CPU)


@pytest.mark.parametrize("dedup", [True, False])
def test_frontier_fold_cache_reuse_matches(dedup):
    """A cache hit (same frontier, new pId_{j-1} column) folds like a
    cold call, in both routes, and a frontier change misses safely."""
    rng = np.random.default_rng(9)
    ns, ne = 12, 40
    seg = np.sort(rng.integers(0, ns, ne)).astype(np.int64)
    lab = rng.integers(0, 3, ne).astype(np.int64)
    p0 = rng.integers(0, 8, ns).astype(np.int64)
    key = np.arange(ns, dtype=np.int64) * 3  # stand-in frontier ids
    cache = {}
    for trial in range(4):  # trial 0 fills, 1-2 hit, 3 misses
        if trial == 3:
            key = key + 1
        tgt = rng.integers(0, 12, ne).astype(np.int64)
        hh, hl = hashes_np.signatures_from_edges(p0, seg, lab, tgt, ns,
                                                 dedup=dedup)
        batch = cache.get("batch")
        dh, dl = dm.frontier_fold(p0, seg, lab, tgt, ns, dedup=dedup,
                                  cache=cache, cache_key=key, device=CPU)
        np.testing.assert_array_equal(dh.numpy(), hh)
        np.testing.assert_array_equal(dl.numpy(), hl)
        assert (cache["batch"] is batch) == (trial in (1, 2))


# ------------------------------------------------------ store resolve
def _fresh_pair(entries=()):
    """A host store, the port's device mirror and the reference's,
    holding the same entries."""
    host = SigStore.empty()
    next_pid = 0
    if len(entries):
        _, next_pid = host.get_or_assign(np.asarray(entries, np.uint64), 0)
    ref = rdm.DeviceSigStore(RefSigStore(host.keys.copy(), host.pids.copy(),
                                         presorted=True))
    return host, DeviceSigStore(host.slice_copy(), CPU), ref, next_pid


def _staged_resolve(dev, qhi, qlo, count, next_pid):
    """The port's staged ladder: _probe_step -> _resolve_step ->
    _merge_step."""
    q = sig.fuse_u32_pair(torch.from_numpy(qhi.astype(np.int64)),
                          torch.from_numpy(qlo.astype(np.int64)))
    out, n_miss = dm._probe_step(dev.key, dev.kpid, q, count, dev.size)
    if int(n_miss) == 0:
        return out[:count].numpy().astype(np.int64), next_pid
    out, plan = dm._resolve_step(dev.key, dev.kpid, q, count, dev.size,
                                 next_pid)
    n = int(plan.n_novel)
    cap = dev.key.numel()
    new_cap = cap if dev.size + n <= cap else bucket(dev.size + n)
    dev.key, dev.kpid = dm._merge_step(dev.key, dev.kpid, plan, dev.size,
                                       new_cap=new_cap)
    dev.size += n
    dev._host = None
    return out[:count].numpy().astype(np.int64), next_pid + n


def _probes(keys, pad=True):
    """Bucket-padded (hi, lo) u32 probe lanes of ``keys``."""
    keys = np.asarray(keys, np.uint64)
    p = bucket(keys.size) if pad else keys.size
    qhi = np.zeros(p, np.uint32)
    qlo = np.zeros(p, np.uint32)
    qhi[:keys.size] = (keys >> np.uint64(32)).astype(np.uint32)
    qlo[:keys.size] = keys.astype(np.uint32)
    return qhi, qlo


def _assert_same_store(dev, host, ref=None):
    np.testing.assert_array_equal(dev.to_host().keys, host.keys)
    np.testing.assert_array_equal(dev.to_host().pids, host.pids)
    if ref is not None:
        assert dev.to_host().to_dict() == ref.to_host().to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_mint_insert_matches_staged_and_reference(seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(1, 2**63, size=400, dtype=np.uint64)
    host, fused, ref, n_f = _fresh_pair(pool[:50])
    _, staged, _, n_s = _fresh_pair(pool[:50])
    n_h = n_r = n_f
    for _ in range(6):
        count = int(rng.integers(1, 120))
        keys = rng.choice(pool, size=count)
        qhi, qlo = _probes(keys)
        got_f, n_f = fused.probe_mint_insert(qhi, qlo, count, n_f)
        got_s, n_s = _staged_resolve(staged, qhi, qlo, count, n_s)
        got_r, n_r = ref.probe_mint_insert(qhi, qlo, count, n_r)
        got_h, n_h = host.get_or_assign(keys, n_h)
        for other in (got_s, got_r, got_h):
            np.testing.assert_array_equal(got_f, other)
        assert n_f == n_s == n_r == n_h
    _assert_same_store(fused, host, ref)
    _assert_same_store(staged, host)


def test_probe_mint_insert_empty_store_all_novel():
    """Resolving against an empty store (everything minted), then a
    second all-novel wave that forces a capacity regrow."""
    host, dev, ref, next_pid = _fresh_pair()
    assert dev.size == 0
    keys = np.arange(1, 11, dtype=np.uint64) * np.uint64(0x9E3779B9)
    got, next_pid = dev.probe_mint_insert(*_probes(keys), 10, next_pid)
    np.testing.assert_array_equal(np.sort(got), np.arange(10))
    assert next_pid == 10 and dev.size == 10
    keys2 = np.arange(100, 160, dtype=np.uint64) * np.uint64(0x85EBCA6B)
    allk = np.concatenate([keys, keys2])
    got2, next_pid = dev.probe_mint_insert(*_probes(allk), allk.size,
                                           next_pid)
    np.testing.assert_array_equal(got2[:10], got)
    assert next_pid == 10 + keys2.size
    assert len(dev.to_host().keys) == dev.size == 10 + keys2.size
    assert dev.key.numel() == bucket(allk.size + 10)
    want, _ = host.get_or_assign(keys, 0)
    want2, _ = host.get_or_assign(allk, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got2, want2)
    _assert_same_store(dev, host)


def test_probe_mint_insert_duplicate_probes_one_pid():
    """Duplicate novel keys inside one batch mint exactly one pid."""
    _, dev, _, next_pid = _fresh_pair()
    qhi, qlo = _probes(np.full(4, 0xDEADBEEFCAFE, np.uint64))
    got, next_pid = dev.probe_mint_insert(qhi, qlo, 4, next_pid)
    assert next_pid == 1 and dev.size == 1
    np.testing.assert_array_equal(got, np.zeros(4, np.int64))


@pytest.mark.parametrize("stored", [False, True])
def test_probe_mint_insert_all_ones_key_beside_padding(stored):
    """A genuine all-ones key shares its value with the sentinel of the
    masked probe lanes and of the store's padding: it must still mint
    (miss-before-masked), survive the merge (real-before-sentinel) and
    resolve afterwards, as `SigStore.get_or_assign` does."""
    entries = [5, 9] + ([ALL_ONES] if stored else [])
    host, dev, ref, next_pid = _fresh_pair(entries)
    n_h = n_r = next_pid
    for keys in ([np.uint64(7), ALL_ONES, np.uint64(5), ALL_ONES],
                 [ALL_ONES, np.uint64(11)], [ALL_ONES]):
        keys = np.asarray(keys, np.uint64)
        qhi, qlo = _probes(keys)  # masked padding lanes follow
        got, next_pid = dev.probe_mint_insert(qhi, qlo, keys.size, next_pid)
        want, n_h = host.get_or_assign(keys, n_h)
        got_r, n_r = ref.probe_mint_insert(qhi, qlo, keys.size, n_r)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, got_r)
        assert next_pid == n_h == n_r
    assert ALL_ONES in dev.to_host().keys
    _assert_same_store(dev, host, ref)


def test_device_store_matches_host_get_or_assign():
    """`get_or_assign_keys` is bit-identical to the host store across
    growth and re-bucketing rounds (both key lanes set)."""
    rng = np.random.default_rng(11)
    host, dev = SigStore.empty(), DeviceSigStore(SigStore.empty(), CPU)
    nh = nd = 0
    for _ in range(12):
        keys = rng.integers(0, 70, rng.integers(1, 50)).astype(np.uint64)
        keys |= rng.integers(0, 4, keys.shape).astype(np.uint64) << \
            np.uint64(32)
        oh, nh = host.get_or_assign(keys, nh)
        od, nd = dev.get_or_assign_keys(keys, nd)
        np.testing.assert_array_equal(oh, od)
        assert nh == nd
    assert dev.to_host().to_dict() == host.to_dict()
    assert len(dev) == len(host)
    assert dev.nbytes == dev.key.numel() * 12


def test_device_store_mirrors_existing_store():
    """Mirroring a populated store keeps lookups and minting aligned, and
    the mirror does not alias the host store it copied."""
    rng = np.random.default_rng(13)
    keys = np.unique(rng.integers(0, 10**9, 100).astype(np.uint64))
    host = SigStore(keys, np.arange(keys.size, dtype=np.int64))
    dev = DeviceSigStore(host, CPU)
    probe = np.concatenate([keys[::3], keys[:5] + np.uint64(1)])
    oh, nh = host.get_or_assign(probe, keys.size)
    od, nd = dev.get_or_assign_keys(probe, keys.size)
    np.testing.assert_array_equal(oh, od)
    assert nh == nd
    assert dev.to_host() is not host
    assert dev.to_host().to_dict() == host.to_dict()


def test_probe_mint_insert_guards_int32_pid_space():
    _, dev, _, _ = _fresh_pair([3])
    with pytest.raises(OverflowError):
        dev.probe_mint_insert(*_probes([np.uint64(4)]), 1, 2**31 - 1)
    with pytest.raises(OverflowError):
        DeviceSigStore(SigStore(np.array([1], np.uint64),
                                np.array([2**31], np.int64)), CPU)


@pytest.mark.parametrize("dedup", [True, False])
def test_resident_levels_match_reference(dedup):
    """The fused k-loop and the per-level resident resolve against the
    reference's, on a random frontier batch over two levels' stores."""
    rng = np.random.default_rng(21 + dedup)
    ns, ne, k = 10, 45, 2
    seg = np.sort(rng.integers(0, ns, ne)).astype(np.int64)
    lab = rng.integers(0, 3, ne).astype(np.int32)
    p0 = rng.integers(0, 4, ns).astype(np.int64)
    tgts = [rng.integers(0, 6, ne).astype(np.int64) for _ in range(k)]
    # stores hold level j's current signatures, so level 0 starts clean
    stores, olds, next_pids = [], [], []
    for j in range(k):
        hi, lo = hashes_np.signatures_from_edges(p0, seg, lab, tgts[j], ns,
                                                 dedup=dedup)
        keys = (hi.astype(np.uint64) << np.uint64(32)) | lo
        host = SigStore.empty()
        pj, npid = host.get_or_assign(keys if j == 0 else keys[:3], 0)
        stores.append(host)
        olds.append(pj if j == 0 else np.zeros(ns, np.int64))
        next_pids.append(npid)
    mine = [DeviceSigStore(s.slice_copy(), CPU) for s in stores]
    ref = [rdm.DeviceSigStore(RefSigStore(s.keys.copy(), s.pids.copy(),
                                          presorted=True)) for s in stores]
    got = dm.resident_levels_resolve(mine, p0, seg, lab, tgts, ns, olds,
                                     next_pids, dedup=dedup)
    want = rdm.resident_levels_resolve(ref, p0, seg, lab, tgts, ns, olds,
                                       next_pids, dedup=dedup)
    assert got[0] == want[0] == 1 and got[2] == want[2]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    got = dm.resident_level_resolve(mine[1], p0, seg, lab, tgts[1], ns,
                                    olds[1], got[2], dedup=dedup)
    want = rdm.resident_level_resolve(ref[1], p0, seg, lab, tgts[1], ns,
                                      olds[1], want[2], dedup=dedup)
    assert got[2:] == want[2:]
    assert (got[0] is None) == (want[0] is None)
    for j in range(k):
        assert mine[j].to_host().to_dict() == ref[j].to_host().to_dict()
