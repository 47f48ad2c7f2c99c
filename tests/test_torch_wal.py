"""The port's write-ahead log, snapshot and recovery (`repro_torch.exmem.
durability.WriteAheadLog`, `OocBackend.snapshot` / `restore`,
`BisimMaintainer.restore`) against the JAX package's, on the CPU.

The cases are those of `tests/test_durability.py` (the WAL protocol,
snapshot/restore with a replayed tail, corrupted snapshots, teardown after
a crash) and the crash-recovery fuzz of `tests/test_update_fuzz.py` (its
op schedule, per-op rngs and snapshot points, imported unchanged).  The
bar is equality with the reference: the records either package writes
replay in the other, byte for byte for the same op; either package
restores the other's snapshot to the same pid history; and a stream killed
at seeded fault points recovers to the never-killed history, which equals
the reference's.
"""
import os
import time

import numpy as np
import pytest

from repro.core import BisimMaintainer as RefMaintainer
from repro.core import FaultPlan as RefFaultPlan
from repro.core import install_fault_plan as ref_install_fault_plan
from repro.exmem import OocBackend as RefOocBackend
from repro.exmem import WriteAheadLog as RefWriteAheadLog
from repro.exmem.durability import _encode_record as ref_encode_record
from repro.graph import generators as rgen
from test_update_fuzz import (_SNAPS, GENERATORS, _apply_indexed,
                              _oracle_check, _op_schedule)

torch = pytest.importorskip("torch")
from repro_torch.core import (BisimMaintainer, ChecksumError,  # noqa: E402
                              FaultPlan, InjectedCrash, install_fault_plan)
from repro_torch.exmem import (AioConfig, OocBackend,  # noqa: E402
                               WriteAheadLog)
from repro_torch.exmem.aio import live_aio_threads  # noqa: E402
from repro_torch.exmem.durability import (_decode_record,  # noqa: E402
                                          _encode_record)
from repro_torch.graph import generators as gen  # noqa: E402

MODES = ["sorted", "dedup_hash", "multiset"]
PORT_GENERATORS = {
    "random": lambda: gen.random_graph(40, 110, 3, 2, seed=2),
    "powerlaw": lambda: gen.powerlaw_graph(36, 100, 2, 2, seed=3),
    "structured": lambda: gen.structured_graph(10, seed=5),
}
# the update batches of one logical op of every kind
RECORDS = [
    ("add_edges", {"src": np.array([1, 2], np.int32),
                   "elabel": np.array([0, 1], np.int32),
                   "dst": np.array([3, 4], np.int32)}),
    ("add_nodes", {"labels": np.array([2, 2, 0], np.int32)}),
    ("delete_node", {"nid": np.array([5], np.int64)}),
    ("delete_edges", {"src": np.array([7], np.int32),
                      "elabel": np.array([1], np.int32),
                      "dst": np.array([8], np.int32)}),
    ("compact", {}),
    ("change_k", {"new_k": np.array([4], np.int64)}),
]


def _graph():
    return gen.random_graph(60, 170, 3, 2, seed=7)


def _ref_graph():
    return rgen.random_graph(60, 170, 3, 2, seed=7)


def _same_records(got, want):
    assert [(lsn, op) for lsn, op, _ in got] == \
        [(lsn, op) for lsn, op, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])


# -------------------------------------------------------------- the WAL
@pytest.mark.parametrize("Wal", [WriteAheadLog, RefWriteAheadLog],
                         ids=["port", "reference"])
def test_wal_append_commit_replay_truncate(tmp_path, Wal):
    """Written by ``Wal``, replayed by both packages."""
    wal = Wal(str(tmp_path / "wal"), group=1)
    a1 = {"src": np.array([1, 2], np.int32), "dst": np.array([3, 4])}
    assert wal.append("add_edges", a1) == 1
    assert wal.append("compact", {}) == 2
    for Reader in (WriteAheadLog, RefWriteAheadLog):
        got = list(Reader(str(tmp_path / "wal")).replay())
        assert [(lsn, op) for lsn, op, _ in got] == [(1, "add_edges"),
                                                    (2, "compact")]
        np.testing.assert_array_equal(got[0][2]["src"], a1["src"])
    wal.truncate(1)
    assert [lsn for lsn, _, _ in wal.replay()] == [2]
    assert wal.append("delete_node", {"nid": np.array([5])}) == 3
    for Reader in (WriteAheadLog, RefWriteAheadLog):
        assert [lsn for lsn, _, _ in
                Reader(str(tmp_path / "wal")).replay()] == [2, 3]


def test_wal_group_commit_bounds_the_loss_window(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), group=3)
    wal.append("a", {})
    wal.append("b", {})
    assert wal.committed_lsn == 0        # below group size: not yet durable
    assert [lsn for lsn, _, _ in wal.replay()] == []
    wal.append("c", {})                  # group full -> auto-commit
    assert wal.committed_lsn == 3
    wal.append("d", {})
    # a crash here loses only the uncommitted tail (<= group-1 records),
    # in either package's reading
    wal2 = WriteAheadLog(str(tmp_path / "wal"), group=3)
    assert [op for _, op, _ in wal2.replay()] == ["a", "b", "c"]
    assert [op for _, op, _ in RefWriteAheadLog(
        str(tmp_path / "wal")).replay()] == ["a", "b", "c"]
    assert wal2.append("e", {}) == 4     # the lost lsn is reused
    wal2.commit()
    assert [op for _, op, _ in wal2.replay()] == ["a", "b", "c", "e"]


@pytest.mark.parametrize("Reader", [WriteAheadLog, RefWriteAheadLog],
                         ids=["port", "reference"])
def test_wal_rejects_corrupt_committed_record(tmp_path, Reader):
    wal = WriteAheadLog(str(tmp_path / "wal"), group=1)
    wal.append("add_edges", {"src": np.arange(64, dtype=np.int64)})
    rec = os.path.join(str(tmp_path / "wal"), "rec_00000001.npy")
    with open(rec, "rb+") as f:
        f.seek(os.path.getsize(rec) - 2)
        f.write(b"\xff")
    from repro.core import ChecksumError as RefChecksumError
    with pytest.raises((ChecksumError, RefChecksumError)):
        list(Reader(str(tmp_path / "wal")).replay())


def test_wal_ignores_torn_commit_line(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"), group=1)
    wal.append("a", {})
    wal.append("b", {})
    log = os.path.join(str(tmp_path / "wal"), "commits.log")
    with open(log, "a") as f:
        f.write("3 12")  # torn mid-line: no trailing fields/newline
    for Reader in (WriteAheadLog, RefWriteAheadLog):
        wal2 = Reader(str(tmp_path / "wal"))
        assert [lsn for lsn, _, _ in wal2.replay()] == [1, 2]
        assert wal2.committed_lsn == 2


def test_wal_lsn_floor_survives_full_truncation(tmp_path):
    """A snapshot that absorbs the whole log leaves commits.log empty;
    the floor file keeps numbering monotone, for either package."""
    wal = WriteAheadLog(str(tmp_path / "wal"), group=1)
    wal.append("a", {})
    wal.append("b", {})
    wal.truncate(2)
    assert RefWriteAheadLog(str(tmp_path / "wal")).committed_lsn == 2
    wal2 = WriteAheadLog(str(tmp_path / "wal"))  # the floor alone
    assert wal2.append("c", {}) == 3
    assert [op for _, op, _ in wal2.replay(after_lsn=2)] == ["c"]
    wal3 = WriteAheadLog(str(tmp_path / "wal3"), start_lsn=7)
    assert wal3.append("d", {}) == 8


@pytest.mark.parametrize("io_threads", [0, 2])
def test_wal_async_commits_drain_on_close(tmp_path, io_threads):
    """Async group commits run on the aio executor; `close` drains every
    in-flight round and commits the pending tail, so every appended
    record replays, in lsn order."""
    aio = AioConfig(io_threads=io_threads)
    wal = WriteAheadLog(str(tmp_path / "wal"), group=2, aio=aio,
                        async_commits=True)
    for i in range(7):
        assert wal.append("add_nodes",
                          {"labels": np.array([i], np.int32)}) == i + 1
    wal.close()
    assert wal.committed_lsn == wal.last_lsn == 7
    aio.close()
    assert live_aio_threads() == []
    for Reader in (WriteAheadLog, RefWriteAheadLog):
        got = list(Reader(str(tmp_path / "wal")).replay())
        assert [lsn for lsn, _, _ in got] == list(range(1, 8))
        assert [int(a["labels"][0]) for _, _, a in got] == list(range(7))


def test_record_codec_bytes_equal_reference(monkeypatch):
    """For the same op the record is the same bytes.  An ``.npz`` member
    carries the zip clock's time, so the clock is pinned for both."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    for op, arrays in RECORDS:
        mine = _encode_record(op, arrays)
        assert mine.dtype == np.uint8
        assert mine.tobytes() == ref_encode_record(op, arrays).tobytes()
        got_op, got = _decode_record(mine)
        assert got_op == op and sorted(got) == sorted(arrays)


def test_wal_files_equal_reference(tmp_path, monkeypatch):
    """The same appends through both logs: equal record files, commit
    log and floor file, byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    logs = [W(str(tmp_path / name), group=2)
            for W, name in ((WriteAheadLog, "port"),
                            (RefWriteAheadLog, "ref"))]
    for wal in logs:
        for op, arrays in RECORDS:
            wal.append(op, arrays)
        wal.truncate(2)
        wal.append("compact", {})
        wal.close()
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "floor.json" in names and "commits.log" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    _same_records(list(logs[0].replay()), list(logs[1].replay()))


# --------------------------------------------- snapshot/restore + replay
def _stream(m, rng):
    n = m.backend.num_nodes
    m.add_edges(rng.integers(0, n, 3).astype(np.int32),
                rng.integers(0, 3, 3).astype(np.int32),
                rng.integers(0, n, 3).astype(np.int32))
    m.delete_node(int(rng.integers(0, n)))
    g = m.graph
    take = rng.integers(0, g.num_edges, 2)
    m.delete_edges(g.src[take], g.elabel[take], g.dst[take])


def _crashed_workdir(tmp_path, package, name, *, device=True):
    """A WAL'd stream snapshotted after its first half and killed (no
    close, no snapshot) after its second: the workdir and the history the
    recovery must give back."""
    wd = str(tmp_path / name)
    if package == "port":
        be = OocBackend(_graph(), chunk_edges=32, chunk_nodes=24,
                        workdir=wd, io_threads=0, wal=True, device="cpu")
        m = BisimMaintainer(be, 2, wal=True, device_propagation=device)
    else:
        be = RefOocBackend(_ref_graph(), chunk_edges=32, chunk_nodes=24,
                           workdir=wd, io_threads=0, wal=True)
        m = RefMaintainer(be, 2, wal=True, device=device)
    rng = np.random.default_rng(0)
    _stream(m, rng)
    m.snapshot()
    _stream(m, rng)         # committed to the WAL, *not* snapshotted
    expect = [np.load(p) for p in be.pid_paths]
    state = dict(next_pid=list(m.next_pid),
                 tombstone=m._tombstone.copy(), edges=be.num_edges)
    be.aio.close()          # simulated crash: no close(), no snapshot
    return wd, expect, state


def _restore(package, wd, *, device=True):
    if package == "port":
        be, state = OocBackend.restore(wd, io_threads=0, device="cpu")
        return BisimMaintainer.restore(be, state, device_propagation=device)
    be, state = RefOocBackend.restore(wd, io_threads=0)
    return RefMaintainer.restore(be, state, device=device)


@pytest.mark.parametrize("restorer", ["port", "reference"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_restore_replays_committed_tail(tmp_path, writer,
                                                 restorer):
    """Either package restores the other's snapshot and replays its WAL
    tail to the pre-crash pid history; the recovery's IOStats equal; and
    the recovered maintainer keeps maintaining as the reference does."""
    wd, expect, st = _crashed_workdir(tmp_path, writer, "m")
    m2 = _restore(restorer, wd)
    assert m2.k == 2 and m2.wal
    for j, p in enumerate(m2.backend.pid_paths):
        np.testing.assert_array_equal(np.load(p), expect[j], err_msg=str(j))
    assert list(m2.next_pid) == st["next_pid"]
    np.testing.assert_array_equal(m2._tombstone, st["tombstone"])
    assert m2.backend.num_edges == st["edges"]
    # the same restore by the reference, from a second crashed copy
    wd_b, _, _ = _crashed_workdir(tmp_path, writer, "m_b")
    ref2 = _restore("reference", wd_b)
    assert m2.backend.io.to_dict() == ref2.backend.io.to_dict()
    assert m2.backend.io.scan_cost > 0
    for m in (m2, ref2):
        _stream(m, np.random.default_rng(1))
    for a, b in zip(m2.backend.pid_paths, ref2.backend.pid_paths):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    assert m2.backend.io.to_dict() == ref2.backend.io.to_dict()
    _oracle_check(m2, (writer, restorer))
    m2.backend.close()
    ref2.backend.close()


def test_restore_rejects_corrupted_snapshot(tmp_path):
    wd = str(tmp_path / "m")
    be = OocBackend(_graph(), chunk_edges=32, chunk_nodes=24, workdir=wd,
                    io_threads=0, wal=True, device="cpu")
    m = BisimMaintainer(be, 2, wal=True)
    m.snapshot()
    be.aio.close()
    pid0 = os.path.join(wd, "snapshot", "pid_000.npy")
    with open(pid0, "rb+") as f:
        f.seek(os.path.getsize(pid0) - 1)
        f.write(b"\x7f")
    with pytest.raises(ChecksumError):
        OocBackend.restore(wd, io_threads=0, device="cpu")


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(ChecksumError):
        OocBackend.restore(str(tmp_path), io_threads=0, device="cpu")


def test_restore_refuses_device_propagation_without_capability(tmp_path):
    """`restore` asks for the device path as the constructor does: a
    backend without it raises, and the host path must be asked for."""
    wd, expect, _ = _crashed_workdir(tmp_path, "port", "m")

    class HostOnly(OocBackend):
        def enable_device(self):
            return False

    be, state = HostOnly.restore(wd, io_threads=0, device="cpu")
    with pytest.raises(ValueError, match="device_propagation=False"):
        BisimMaintainer.restore(be, state)
    m = BisimMaintainer.restore(be, state, device_propagation=False)
    assert not m.device_propagation
    for j, p in enumerate(be.pid_paths):
        np.testing.assert_array_equal(np.load(p), expect[j])
    be.close()


def test_backend_close_is_idempotent_even_after_crash(tmp_path):
    be = OocBackend(_graph(), chunk_edges=32, chunk_nodes=24,
                    workdir=str(tmp_path / "m"), io_threads=0, device="cpu")
    m = BisimMaintainer(be, 2)
    with install_fault_plan(FaultPlan(crash_at=2)):
        with pytest.raises(InjectedCrash):
            m.add_edges(np.array([0], np.int32), np.array([0], np.int32),
                        np.array([1], np.int32))
    be.close()
    be.close()  # idempotent
    assert live_aio_threads() == []


# -------------------------------------------------- crash-recovery fuzz
RECOVERY_GENERATORS = ["random", "structured"]


def _port_wal_maintainer(workdir, gname, mode, *, device=True):
    backend = OocBackend(PORT_GENERATORS[gname](), chunk_edges=32,
                         chunk_nodes=24, spill_threshold=16,
                         workdir=workdir, io_threads=0, wal=True,
                         device="cpu")
    return BisimMaintainer(backend, 2, mode=mode, wal=True,
                           device_propagation=device)


def _ref_wal_maintainer(workdir, gname, mode):
    backend = RefOocBackend(GENERATORS[gname](), chunk_edges=32,
                            chunk_nodes=24, spill_threshold=16,
                            workdir=workdir, io_threads=0, wal=True)
    return RefMaintainer(backend, 2, mode=mode, wal=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gname", RECOVERY_GENERATORS)
def test_crash_recovery_at_seeded_kill_points(tmp_path, gname, mode):
    """test_update_fuzz's crash-recovery stream (seed 909): the port with
    device propagation killed at seeded fault points over the stream
    after its first snapshot, restored and finished, gives the
    never-killed run's pid history, which equals the reference's.  On the
    host path the port's observer pass counts the reference's fault
    points; the device path adds its per-level ``device`` points."""
    seed = 909
    ops = _op_schedule(seed)

    ref = _ref_wal_maintainer(str(tmp_path / "ref"), gname, mode)
    _apply_indexed(ref, ops, 0, _SNAPS[0], seed)
    with ref_install_fault_plan(RefFaultPlan()) as ref_seen:
        _apply_indexed(ref, ops, _SNAPS[0], len(ops), seed)
    ref_pids = [np.load(p) for p in ref.backend.pid_paths]
    ref_next = list(ref.next_pid)
    ref.backend.close()

    counts = {}
    for route in ("host", "device"):
        m = _port_wal_maintainer(str(tmp_path / f"obs-{route}"), gname,
                                 mode, device=route == "device")
        lsn_after = []
        for i in range(_SNAPS[0]):
            _apply_indexed(m, ops, i, i + 1, seed)
            lsn_after.append(m.backend._wal.last_lsn)
        with install_fault_plan(FaultPlan()) as seen:
            for i in range(_SNAPS[0], len(ops)):
                _apply_indexed(m, ops, i, i + 1, seed)
                lsn_after.append(m.backend._wal.last_lsn)
        counts[route] = seen.points_seen
        for j, p in enumerate(m.backend.pid_paths):
            np.testing.assert_array_equal(np.load(p), ref_pids[j],
                                          err_msg=f"{route} level {j}")
        assert list(m.next_pid) == ref_next
        m.backend.close()
    assert counts["host"] == ref_seen.points_seen
    assert counts["device"] >= counts["host"] > 10

    total = counts["device"]
    kill_rng = np.random.default_rng(seed)
    points = sorted({1, total} | {int(x) for x in
                                  kill_rng.integers(2, total, 6)})
    for n in points:
        wd = str(tmp_path / f"kill_{n:04d}")
        m = _port_wal_maintainer(wd, gname, mode)
        _apply_indexed(m, ops, 0, _SNAPS[0], seed)
        with install_fault_plan(FaultPlan(crash_at=n)):
            with pytest.raises(InjectedCrash):
                _apply_indexed(m, ops, _SNAPS[0], len(ops), seed)
        m.backend.aio.close()   # the "dead" process: no clean close

        be2, state = OocBackend.restore(wd, io_threads=0, device="cpu")
        m2 = BisimMaintainer.restore(be2, state)
        committed = be2._wal.committed_lsn
        done = 0
        while done < len(ops) and lsn_after[done] <= committed:
            done += 1
        _apply_indexed(m2, ops, done, len(ops), seed)
        assert m2.k == len(ref_pids) - 1
        for j, p in enumerate(be2.pid_paths):
            np.testing.assert_array_equal(
                np.load(p), ref_pids[j],
                err_msg=f"{gname}/{mode} kill point {n}, level {j}")
        assert list(m2.next_pid) == ref_next, (n,)
        _oracle_check(m2, ("recovery", gname, mode, n))
        be2.close()
