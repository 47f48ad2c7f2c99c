"""The port's streaming maintenance service (`repro_torch.exmem.service`)
against the JAX package's, on the CPU.

Every case of `tests/test_stream.py` runs through the port: the same op
streams (`synthesize_ops`, whose draws are the port's copy), the same
scheduling knobs, the fuzz harness's WAL'd maintainers and op schedule
(imported unchanged).  The port propagates on the device route
(``device="cpu"``: the folds take the kernels' plain versions) unless a
case says otherwise.  The bar is the reference's: pid histories
bit-identical across batch boundaries, kill points and recovery, and
equal to the JAX service's on the same stream; the staleness bound kept;
pinned epoch views never scribbled on; the WAL's lsns monotone and its
records equal.  On top: the ``stats()`` counters equal the JAX
service's (wall-clock fields apart), the maintainer's ``on_rebuild`` hook
fires with the reference's (level, frontier), and the port's `recover`
resumes a workdir the JAX service left killed.
"""
import os
import threading
import types

import numpy as np
import pytest

import test_update_fuzz as fuzz
from repro.core import BisimMaintainer as RefMaintainer
from repro.core import FaultPlan as RefFaultPlan
from repro.core import InjectedCrash as RefInjectedCrash
from repro.core import install_fault_plan as ref_install_fault_plan
from repro.exmem import OocBackend as RefOocBackend
from repro.exmem import StreamConfig as RefStreamConfig
from repro.exmem import StreamingMaintenanceService as RefService
from repro.exmem import WriteAheadLog as RefWriteAheadLog
from repro.exmem import replay_open_loop as ref_replay
from repro.exmem import synthesize_ops as ref_synthesize_ops
from repro.quotient import QuotientService as RefQuotientService
from test_stream import N_OPS, SEED
from test_torch_wal import PORT_GENERATORS, _port_wal_maintainer

torch = pytest.importorskip("torch")
from repro_torch.core import (BisimMaintainer, FaultPlan,  # noqa: E402
                              InjectedCrash, build_bisim, install_fault_plan,
                              same_partition)
from repro_torch.exmem import (OocBackend, StreamConfig,  # noqa: E402
                               StreamingMaintenanceService, WriteAheadLog,
                               replay_open_loop, synthesize_ops)
from repro_torch.exmem.aio import live_aio_threads  # noqa: E402
from repro_torch.quotient import (LabelPath, PointLookup,  # noqa: E402
                                  QuotientService)

WALL = ("wall_s", "updates_per_sec")


def _quiet(**kw):
    """test_stream's deterministic scheduling (no deadline races, no
    state-timed compaction)."""
    base = dict(batch_ops=4, batch_deadline_s=10.0, snapshot_every=2,
                staleness_batches=1, compact_threshold=0.0)
    base.update(kw)
    return base


def _backend_kw(workdir, io_threads, wal_group, wal_async):
    return dict(chunk_edges=32, chunk_nodes=24, spill_threshold=16,
                workdir=str(workdir), io_threads=io_threads, wal=True,
                wal_group=wal_group, wal_async=wal_async)


def _svc(workdir, cfg, *, io_threads=0, wal_group=1, quotient=False, k=2,
         mode="sorted", wal_async=False, route="device"):
    backend = OocBackend(PORT_GENERATORS["random"](), device="cpu",
                         **_backend_kw(workdir, io_threads, wal_group,
                                       wal_async))
    m = BisimMaintainer(backend, k, mode=mode, wal=True,
                        device_propagation=route == "device")
    q = (QuotientService(m, str(workdir), aio=backend.aio)
         if quotient else None)
    return StreamingMaintenanceService(m, config=StreamConfig(**cfg),
                                       quotient=q)


def _ref_svc(workdir, cfg, *, io_threads=0, wal_group=1, quotient=False,
             k=2, mode="sorted", wal_async=False):
    backend = RefOocBackend(fuzz.GENERATORS["random"](),
                            **_backend_kw(workdir, io_threads, wal_group,
                                          wal_async))
    m = RefMaintainer(backend, k, mode=mode, wal=True)
    q = (RefQuotientService(m, str(workdir), aio=backend.aio)
         if quotient else None)
    return RefService(m, config=RefStreamConfig(**cfg), quotient=q)


def _ops():
    return synthesize_ops(N_OPS, num_nodes=40, seed=SEED)


def _pids_of(m):
    return [np.asarray(m.pids[j]).copy() for j in range(m.k + 1)]


def _same_history(a, b, ctx=()):
    assert len(a) == len(b), ctx
    for j, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"{ctx} level {j}")


def _stats(svc):
    st = svc.stats()
    for key in WALL:
        st.pop(key)
    return st


def _oracle(m, ctx):
    ref = build_bisim(m.graph, m.k, mode=m.mode, early_stop=False,
                      device="cpu")
    for j in range(m.k + 1):
        assert same_partition(m.pids[j], ref.pids[j]), (*ctx, j)


def _ref_history(tmp_path, cfg, ops=None, **kw):
    ref = _ref_svc(tmp_path / "jax", cfg, **kw)
    lsns = ref_replay(ref, ops if ops is not None else _ops())
    ref.close()
    out = (_pids_of(ref.m), list(ref.m.next_pid), _stats(ref), lsns)
    ref.m.backend.close()
    return out


# --------------------------------------------------------- op synthesis
def test_synthesize_ops_equal_reference():
    for kw in (dict(), dict(num_labels=2, num_elabels=5, seed=3,
                            max_edges_per_op=9)):
        mine = synthesize_ops(60, num_nodes=40, **kw)
        want = ref_synthesize_ops(60, num_nodes=40, **kw)
        assert [op for op, _ in mine] == [op for op, _ in want]
        for (_, a), (_, b) in zip(mine, want):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_stream_config_validation():
    for bad in (dict(batch_ops=0), dict(staleness_batches=0)):
        with pytest.raises(ValueError):
            StreamConfig(**bad)
    with pytest.raises(ValueError, match="unknown streaming op"):
        StreamingMaintenanceService(
            types.SimpleNamespace(wal=False)).submit("rename", {})


# ---------------------------------------------- batch-boundary invariance
@pytest.mark.parametrize("route", ["device", "host"])
def test_batch_boundaries_do_not_change_pid_history(tmp_path, route):
    ops = _ops()
    want_pids, want_next, _, _ = _ref_history(tmp_path, _quiet(
        batch_ops=16))
    for batch_ops in (1, 3, 16):
        svc = _svc(tmp_path / f"b{batch_ops}", _quiet(batch_ops=batch_ops),
                   route=route)
        replay_open_loop(svc, ops)
        svc.close()
        _same_history(_pids_of(svc.m), want_pids, ("batch", batch_ops))
        assert list(svc.m.next_pid) == want_next
        _oracle(svc.m, ("stream-batch", batch_ops))
        svc.m.backend.close()


# ------------------------------------------------------- staleness bound
def test_staleness_stays_within_bound(tmp_path):
    cfg = _quiet(batch_ops=2, staleness_batches=2)
    svc = _svc(tmp_path / "port", cfg, quotient=True)
    replay_open_loop(svc, _ops())
    svc.close()
    st = svc.stats()
    assert st["max_staleness"] <= st["staleness_bound"] == 2
    assert st["absorbed"] >= 1 and st["epoch"] >= 1
    assert st["pending"] == 0, "drain left ops behind"
    want_pids, want_next, want_stats, _ = _ref_history(
        tmp_path, cfg, quotient=True)
    assert _stats(svc) == want_stats
    _same_history(_pids_of(svc.m), want_pids)
    svc.m.backend.close()


def test_stream_counters_equal_reference_with_compaction(tmp_path):
    """The default scheduling, compaction included (a delete-heavy mix
    crosses the tombstone threshold): every counter equals the JAX
    service's, and so does the final history."""
    mix = (("add_edges", 0.3), ("delete_node", 0.7))
    ops = synthesize_ops(40, num_nodes=40, seed=SEED, mix=mix)
    cfg = dict(batch_ops=4, batch_deadline_s=10.0, snapshot_every=3,
               staleness_batches=2, compact_threshold=0.25)
    svc = _svc(tmp_path / "port", cfg, quotient=True)
    lsns = replay_open_loop(svc, ops)
    svc.close()
    want_pids, want_next, want_stats, want_lsns = _ref_history(
        tmp_path, cfg, ops=ops, quotient=True)
    assert want_stats["compactions_scheduled"] >= 1
    assert _stats(svc) == want_stats and lsns == want_lsns
    _same_history(_pids_of(svc.m), want_pids)
    assert list(svc.m.next_pid) == want_next
    svc.m.backend.close()


# -------------------------------------------------- epoch-pinned reads
def test_patch_is_copy_on_write_for_pinned_views(tmp_path):
    svc = _svc(tmp_path, _quiet(), quotient=True)
    ops = _ops()
    replay_open_loop(svc, ops[:8])
    svc.drain()
    eng = svc.q.engine
    view0 = eng._view
    frozen = ([a.copy() for a in view0.labels], list(view0.counts),
              [r.n_blocks for r in view0.runs], view0.epoch,
              {j: [t.clone() for t in ts]
               for j, ts in view0.dev_levels.items()})
    replay_open_loop(svc, ops[8:])
    svc.close()
    assert eng._view is not view0, "absorb published no new view"
    assert eng._view.epoch > view0.epoch
    labels0, counts0, nblocks0, epoch0, dev0 = frozen
    assert view0.epoch == epoch0
    assert list(view0.counts) == counts0
    assert [r.n_blocks for r in view0.runs] == nblocks0
    for j, a in enumerate(view0.labels):
        np.testing.assert_array_equal(
            a, labels0[j], err_msg=f"pinned labels[{j}] were scribbled on")
    for j, ts in dev0.items():
        for a, b in zip(view0.dev_levels[j], ts):
            assert torch.equal(a, b), f"pinned level {j} tensors changed"
    svc.m.backend.close()


def test_queries_admitted_during_patches_never_tear(tmp_path):
    svc = _svc(tmp_path, _quiet(batch_ops=2), quotient=True)
    queries = [LabelPath((0,), level=1), LabelPath((1,), level=1),
               LabelPath((0, 1), level=2), PointLookup(0, 1),
               PointLookup(0, 2)]
    stop = threading.Event()
    errors, epochs = [], []

    def hammer():
        try:
            while not stop.is_set():
                epochs.append(svc.q.engine._view.epoch)
                answers = svc.q.query(queries)
                assert len(answers) == len(queries)
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        replay_open_loop(
            svc, synthesize_ops(2 * N_OPS, num_nodes=40, seed=SEED))
        svc.drain()
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert epochs == sorted(epochs), "epoch went backwards under a reader"
    assert svc.q.epoch >= 1
    svc.close()
    svc.m.backend.close()


# ------------------------------------------------ truncation lsn floor
def test_truncate_kill_points_keep_lsn_monotone(tmp_path):
    """A kill at every fault point inside `WriteAheadLog.truncate` (fired
    by the snapshot's truncation) recovers the JAX run's state, and the
    next append takes a fresh lsn."""
    ops = fuzz._op_schedule(SEED)
    ref = fuzz._wal_maintainer(str(tmp_path / "ref"), "random", "sorted")
    fuzz._apply_indexed(ref, ops, 0, fuzz._SNAPS[0], SEED)
    ref_pids, last_lsn = _pids_of(ref), ref.backend._wal.last_lsn
    ref.backend.close()
    assert last_lsn > 0

    obs_m = _port_wal_maintainer(str(tmp_path / "obs"), "random", "sorted")
    with install_fault_plan(FaultPlan()) as plan:
        fuzz._apply_indexed(obs_m, ops, 0, fuzz._SNAPS[0], SEED)
    trunc_points = [idx for idx, kind, _ in plan.log
                    if kind == "wal_truncate"]
    assert obs_m.backend._wal.last_lsn == last_lsn
    obs_m.backend.close()
    assert len(trunc_points) >= 3, "truncate lost its fault points"

    for n in trunc_points:
        wd = str(tmp_path / f"kill_{n:04d}")
        m = _port_wal_maintainer(wd, "random", "sorted")
        with install_fault_plan(FaultPlan(crash_at=n)):
            with pytest.raises(InjectedCrash):
                fuzz._apply_indexed(m, ops, 0, fuzz._SNAPS[0], SEED)
        m.backend.aio.close()

        be2, state = OocBackend.restore(wd, io_threads=0, device="cpu")
        m2 = BisimMaintainer.restore(be2, state)
        _same_history(_pids_of(m2), ref_pids, ("truncate kill point", n))
        m2.add_edges([0], [0], [1])
        assert be2._wal.last_lsn > last_lsn, \
            f"kill point {n} reused an acknowledged lsn"
        be2.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_lsn_floor_survives_reopen_after_full_truncation(tmp_path, writer):
    Wal = WriteAheadLog if writer == "port" else RefWriteAheadLog
    wal = Wal(str(tmp_path))
    for i in range(3):
        wal.append("add_nodes", dict(labels=np.asarray([i], np.int32)))
    wal.truncate(wal.last_lsn)
    wal.close()
    assert not list(WriteAheadLog(str(tmp_path)).replay())
    reopened = WriteAheadLog(str(tmp_path))
    assert reopened.append(
        "add_nodes", dict(labels=np.asarray([9], np.int32))) == 4
    reopened.close()


# ------------------------------------------ close drains async rounds
def test_backend_close_drains_inflight_group_commit(tmp_path):
    svc = _svc(tmp_path, _quiet(snapshot_every=0, async_wal=True),
               io_threads=2, wal_group=4, wal_async=True)
    replay_open_loop(svc, synthesize_ops(10, num_nodes=40, seed=SEED))
    svc.drain()
    wal_root, last = svc.m.backend._wal.root, svc.m.backend._wal.last_lsn
    assert last == 10
    svc.m.backend.close()
    assert live_aio_threads() == []
    with open(os.path.join(wal_root, "commits.log")) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln]
    assert all(len(t) == 3 and all(x.isdigit() for x in t)
               for t in lines), "torn or malformed commit line published"
    recs = list(WriteAheadLog(wal_root).replay())
    assert [lsn for lsn, _, _ in recs] == list(range(1, last + 1)), \
        "close lost acknowledged records"


# --------------------------------------------- async == sync WAL content
def test_async_and_sync_wal_commit_identical_records(tmp_path):
    """Async and sync group commit log the same records, which equal the
    JAX service's, and land on its history."""
    ops = _ops()
    runs = {}
    for label, wal_async in (("sync", False), ("async", True)):
        cfg = _quiet(snapshot_every=0, async_wal=wal_async)
        svc = _svc(tmp_path / label, cfg, io_threads=2, wal_group=3,
                   wal_async=wal_async)
        replay_open_loop(svc, ops)
        svc.close(snapshot=False)
        root = svc.m.backend._wal.root
        pids = _pids_of(svc.m)
        svc.m.backend.close()
        runs[label] = (pids, list(WriteAheadLog(root).replay()))
    ref = _ref_svc(tmp_path / "jax", _quiet(snapshot_every=0), io_threads=2,
                   wal_group=3)
    ref_replay(ref, ops)
    ref.close(snapshot=False)
    ref_root, ref_pids = ref.m.backend._wal.root, _pids_of(ref.m)
    ref.m.backend.close()
    runs["jax"] = (ref_pids, list(RefWriteAheadLog(ref_root).replay()))
    pids_s, recs_s = runs["sync"]
    for label in ("async", "jax"):
        pids, recs = runs[label]
        _same_history(pids, pids_s, (label,))
        assert [(lsn, op) for lsn, op, _ in recs] == \
            [(lsn, op) for lsn, op, _ in recs_s]
        for (_, _, a), (_, _, b) in zip(recs, recs_s):
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------- crash mid-ingest
def test_stream_crash_recovery_bit_identical(tmp_path):
    """Kill the port's service at seeded fault points over the whole
    schedule; `recover` + resubmitting the lost suffix lands on the
    never-killed history, which equals the JAX service's."""
    cfg = _quiet()
    ops = _ops()
    ref_pids, ref_next, _, ref_lsns = _ref_history(tmp_path, cfg)
    assert ref_lsns == sorted(ref_lsns), "submit acks must be monotone"

    obs_svc = _svc(tmp_path / "obs", cfg)
    with install_fault_plan(FaultPlan()) as plan:
        lsns = replay_open_loop(obs_svc, ops)
        obs_svc.close()
    total = plan.points_seen
    _same_history(_pids_of(obs_svc.m), ref_pids, ("observer",))
    obs_svc.m.backend.close()
    assert lsns == ref_lsns
    assert total > 10, "fault-injection coverage collapsed"

    kill_rng = np.random.default_rng(SEED)
    points = sorted({1, total} | {int(x) for x in
                                  kill_rng.integers(2, total, 4)})
    for n in points:
        wd = str(tmp_path / f"kill_{n:04d}")
        svc = _svc(wd, cfg)
        svc.snapshot()              # the pre-stream baseline (restore base)
        with install_fault_plan(FaultPlan(crash_at=n)):
            with pytest.raises(InjectedCrash):
                replay_open_loop(svc, ops)
                svc.close()
        svc.m.backend.aio.close()   # the dead process: no clean close

        rec = StreamingMaintenanceService.recover(wd, io_threads=0,
                                                  device="cpu",
                                                  config=StreamConfig(**cfg))
        assert rec.m.device_propagation
        committed = rec.m.backend._wal.committed_lsn
        done = sum(1 for lsn in ref_lsns if lsn <= committed)
        replay_open_loop(rec, ops[done:])
        rec.close()
        assert list(rec.m.next_pid) == ref_next, (n,)
        _same_history(_pids_of(rec.m), ref_pids, ("stream kill point", n))
        rec.m.backend.close()


@pytest.mark.parametrize("quotient", [False, True])
def test_port_recovers_a_killed_reference_stream(tmp_path, quotient):
    """The JAX service is killed mid-stream; the port's `recover` adopts
    its snapshot and committed WAL, takes the lost suffix and reaches
    the JAX service's uninterrupted history (with a rematerialized
    quotient index when asked)."""
    cfg = _quiet()
    ops = _ops()
    ref_pids, ref_next, _, ref_lsns = _ref_history(tmp_path, cfg)
    with ref_install_fault_plan(RefFaultPlan()) as seen:
        probe = _ref_svc(tmp_path / "probe", cfg)
        ref_replay(probe, ops)
        probe.close()
    probe.m.backend.close()
    kill_at = int(np.random.default_rng(SEED).integers(
        seen.points_seen // 3, 2 * seen.points_seen // 3))

    wd = tmp_path / "killed"
    ref = _ref_svc(wd, cfg)
    ref.snapshot()
    with ref_install_fault_plan(RefFaultPlan(crash_at=kill_at)):
        with pytest.raises(RefInjectedCrash):
            ref_replay(ref, ops)
            ref.close()
    ref.m.backend.aio.close()

    rec = StreamingMaintenanceService.recover(
        str(wd), io_threads=0, device="cpu", config=StreamConfig(**cfg),
        quotient=quotient)
    committed = rec.m.backend._wal.committed_lsn
    done = sum(1 for lsn in ref_lsns if lsn <= committed)
    assert 0 < done < len(ops)
    replay_open_loop(rec, ops[done:])
    rec.close()
    _same_history(_pids_of(rec.m), ref_pids, ("cross-package recovery",))
    assert list(rec.m.next_pid) == ref_next
    if quotient:
        assert rec.q.epoch == rec.stats()["epoch"] >= 1
        ans = rec.q.query([PointLookup(0, 2)])[0]
        assert ans.pid == int(ref_pids[2][0])
    rec.m.backend.close()


# ------------------------------------------------------- rebuild hook
def _rebuild_stream(m, calls):
    """A fuzz stream, then one insert from most nodes at once: the §4.2
    heuristic fires; every call of the hook is recorded."""
    m.on_rebuild = lambda level, frontier: calls.append((level, frontier))
    rng = np.random.default_rng(77)
    for _ in range(6):
        fuzz._apply_op(m, fuzz.OPS[int(rng.integers(0, 3))], rng)
    n = m.backend.num_nodes
    src = np.arange(0, n, 2, dtype=np.int32)[: int(0.6 * n)]
    m.add_edges(src, np.zeros_like(src), (src + 1) % n)
    m.add_edges(np.arange(3, dtype=np.int32), np.ones(3, np.int32),
                np.arange(1, 4, dtype=np.int32))


@pytest.mark.parametrize("backend", ["inmemory", "oocore"])
def test_on_rebuild_hook_matches_reference(tmp_path, backend):
    """The §4.2 branch calls ``on_rebuild(level, frontier)`` exactly
    where, and with what, the reference calls it; `restore` resets it."""
    if backend == "inmemory":
        m = BisimMaintainer(PORT_GENERATORS["random"](), 3, device="cpu",
                            rebuild_threshold=0.3)
        ref = RefMaintainer(fuzz.GENERATORS["random"](), 3,
                            rebuild_threshold=0.3)
    else:
        kw = dict(chunk_edges=32, chunk_nodes=24, io_threads=0, wal=True)
        m = BisimMaintainer(OocBackend(PORT_GENERATORS["random"](),
                                       workdir=str(tmp_path / "p"),
                                       device="cpu", **kw), 3, wal=True,
                            rebuild_threshold=0.3)
        ref = RefMaintainer(RefOocBackend(fuzz.GENERATORS["random"](),
                                          workdir=str(tmp_path / "r"), **kw),
                            3, wal=True, rebuild_threshold=0.3)
    assert m.on_rebuild is None
    calls, ref_calls = [], []
    _rebuild_stream(m, calls)
    _rebuild_stream(ref, ref_calls)
    assert calls == ref_calls and len(calls) >= 1
    _same_history(_pids_of(m), _pids_of(ref))
    if backend == "oocore":
        m.snapshot()
        be, state = OocBackend.restore(str(tmp_path / "p"), io_threads=0,
                                       device="cpu")
        assert BisimMaintainer.restore(be, state).on_rebuild is None
        be.close()
        m.backend.close()
        ref.backend.close()


def test_service_counts_rebuilds_and_snapshots_early(tmp_path):
    """The streaming service hooks the maintainer: a rebuild is counted
    and forces the next snapshot, as in the reference."""
    ops = [("add_edges", dict(src=np.arange(0, 40, 2, dtype=np.int32),
                              elabel=np.zeros(20, np.int32),
                              dst=np.arange(1, 41, 2, dtype=np.int32)))]
    ops += _ops()[:6]
    cfg = _quiet(batch_ops=1, snapshot_every=5)
    svc = _svc(tmp_path / "port", cfg, quotient=True)
    replay_open_loop(svc, ops)
    svc.close()
    _, _, want_stats, _ = _ref_history(tmp_path, cfg, ops=ops,
                                       quotient=True)
    st = _stats(svc)
    assert st == want_stats
    assert st["rebuilds"] >= 1 and st["snapshots"] >= 2
    svc.m.backend.close()
