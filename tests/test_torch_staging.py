"""The pinned ring of `repro_torch.core.staging`, without a card.

The ring's chunk and slot rotation runs here with plain CPU tensors as
slots and a CPU destination: the staged columns must equal their sources
bit for bit, each slot must hold the last chunk the rotation gave it,
and only an upload to a card past the threshold may engage the ring.
The ``gpu`` cases of ``tests/test_torch_kernels_gpu.py`` run the same
shapes through pinned slots and CUDA events on the card."""
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch import obs  # noqa: E402
from repro_torch.core import build_bisim  # noqa: E402
from repro_torch.core import staging  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402

SLOT_BYTES = 64          # 16 int32 a chunk
SLOTS = 3
PER = SLOT_BYTES // 4


def _cpu_ring(slots=SLOTS, slot_bytes=SLOT_BYTES):
    return staging.PinnedRing(torch.empty(slot_bytes, dtype=torch.uint8)
                              for _ in range(slots))


def _column(n, seed):
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)


def _columns(g):
    return [g.node_labels, g.src, g.dst, g.elabel]


def column_cases(per):
    """Columns to stage in one go, by case, for chunks of ``per`` int32
    (the card's tests stage the same shapes)."""
    return {
        "shorter_than_a_chunk": lambda: [_column(per - 6, 1)],
        "not_a_multiple_of_the_chunk": lambda: [_column(5 * per + 3, 2)],
        "more_chunks_than_slots": lambda: [_column(7 * per, 3),
                                           _column(2 * per + 1, 4)],
        "zero_length_elabel": lambda: [_column(40, 5), _column(0, 6),
                                       _column(0, 7), _column(0, 8)],
        "non_contiguous_view": lambda: [_column(9 * per + 5, 9)[::3],
                                        _column(4 * per, 10)[::-1]],
        "graph_columns": lambda: _columns(
            gen.powerlaw_graph(150, 700, 3, 2, seed=5)),
    }


CASES = column_cases(PER)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_stages_columns_bit_for_bit(case):
    columns = CASES[case]()
    ring = _cpu_ring()
    dst = [torch.full((len(x),), -7, dtype=torch.int32) for x in columns]
    chunks = sum(ring.stage(x, t) for x, t in zip(columns, dst))
    for x, t in zip(columns, dst):
        assert np.array_equal(t.numpy(), x)
    # every chunk a slot's worth but the last of each column
    assert chunks == sum(-(-len(x) // PER) for x in columns)
    # chunk c went to slot c % SLOTS: each slot holds its last chunk
    pieces = [x[a:a + PER] for x in columns for a in range(0, len(x), PER)]
    for s in range(min(SLOTS, len(pieces))):
        last = pieces[max(c for c in range(len(pieces)) if c % SLOTS == s)]
        held = ring.slots[s][:last.nbytes].view(torch.int32).numpy()
        assert np.array_equal(held, last)


def test_ring_turn_carries_over_between_uploads():
    ring = _cpu_ring()
    a, b = _column(2 * PER, 11), _column(2 * PER, 12)
    da, db = torch.empty(len(a), dtype=torch.int32), torch.empty(
        len(b), dtype=torch.int32)
    assert ring.stage(a, da) == 2
    assert ring.stage(b, db) == 2
    # four chunks over three slots: the second upload's first chunk took
    # slot 2, its second wrapped to slot 0, where a's first had been
    held = [s.view(torch.int32).numpy() for s in ring.slots]
    assert np.array_equal(held[2], b[:PER])
    assert np.array_equal(held[0], b[PER:])
    assert np.array_equal(held[1], a[PER:])
    assert np.array_equal(da.numpy(), a) and np.array_equal(db.numpy(), b)


def test_threads_sharing_the_ring_each_get_their_own_column():
    """More threads than cores stage distinct columns through one ring at
    once, with a short switch interval: a chunk refilled by another
    thread before its copy would show in a column (slots of 256 KiB, so
    each copy releases the GIL for a while)."""
    ring = _cpu_ring(slot_bytes=1 << 18)
    columns = [_column(20 * (1 << 16) + t, 100 + t)
               for t in range(2 * (os.cpu_count() or 4))]
    dst = [torch.empty(len(x), dtype=torch.int32) for x in columns]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ring.stage, args=(x, t))
                   for x, t in zip(columns, dst)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    for x, t in zip(columns, dst):
        assert np.array_equal(t.numpy(), x)


def test_threshold_keeps_small_uploads_on_the_direct_path():
    g = gen.powerlaw_graph(150, 700, 3, 2, seed=5)
    small = sum(x.nbytes for x in _columns(g))
    limit = staging.ENGAGE_SLOTS * staging.SLOT_BYTES
    card = torch.device("cuda")
    assert not staging.engages(card, small)
    assert not staging.engages(card, limit)
    assert staging.engages(card, limit + 1)
    for dev in ("cpu", "meta"):
        assert not staging.engages(torch.device(dev), 100 * limit)
    # below the threshold: the direct copy, which on the CPU aliases
    tensors, chunks = staging.upload([g.src, g.elabel], torch.device("cpu"))
    assert chunks == 0
    assert tensors[0].data_ptr() == g.src.ctypes.data


def test_staged_build_equals_direct_build(monkeypatch):
    """A build whose upload goes through the ring (CPU slots, engaged by
    hand) gives the pids, counts and stores of the direct upload."""
    g = gen.powerlaw_graph(300, 1500, 3, 2, seed=7)
    direct = build_bisim(g, 5, device="cpu", with_store=True)
    ring = _cpu_ring(slots=2, slot_bytes=256)
    monkeypatch.setattr(staging, "engages", lambda dev, nbytes: True)
    monkeypatch.setattr(staging, "ring", lambda: ring)
    with obs.tracing() as tracer:
        staged = build_bisim(g, 5, device="cpu", with_store=True)
    (up,) = tracer.find("build.upload")
    assert up["attrs"]["staged_chunks"] == sum(
        -(-x.nbytes // 256) for x in _columns(g))
    assert np.array_equal(direct.pids, staged.pids)
    assert direct.counts == staged.counts
    assert direct.next_pid == staged.next_pid
    for a, b in zip(direct.stores, staged.stores):
        assert np.array_equal(a.keys, b.keys)
        assert np.array_equal(a.pids, b.pids)
