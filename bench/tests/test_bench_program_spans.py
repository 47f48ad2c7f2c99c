"""The readers of the program's own spans and counters (``host.hold_ms``,
``copy.h2d_gb``, ``copy.d2h_gb``, ``levels.device_ms``) on a made-up
trace, and on a traced toy run on the CPU."""
from __future__ import annotations

import pytest

from bench import harness, profview, registry
from bench.tests.toy import CELLS, toy_root

NEW = ("host.hold_ms", "copy.h2d_gb", "copy.d2h_gb", "levels.device_ms")


def _copy(what, to, nbytes):
    return {"name": "build.copy",
            "attrs": {"what": what, "to": to, "bytes": nbytes}}


def _level(j, ms):
    return {"name": "build.level",
            "attrs": {"level": j, "device_ms": ms, "trimmed": False}}


def view(**kw):
    """Two builds in a 1000 us window.  Build 1 (0..400): upload on the
    card 10..100, idle 100..150 under ``build.prepare``, busy 150..300,
    idle 300..330 under an ``aten::to`` inside ``build.fetch``, idle
    330..360 under ``build.fetch`` itself, busy 360..380, idle 380..400
    directly under ``build.bisim``.  Between the builds (400..500) the
    card idles under the harness alone.  Build 2 (500..900): busy
    500..880, idle 880..900 under ``build.drain``; idle 900..1000 after
    it."""
    base = dict(
        builds=2, window=(0.0, 1000.0),
        device=[("Memcpy HtoD (Pageable -> Device)", 0.0, 100.0),
                ("void cub::DeviceRadixSortOnesweepKernel<...>", 150.0,
                 300.0),
                ("Memcpy DtoH (Device -> Pageable)", 360.0, 380.0),
                ("void at::native::elementwise_kernel<...>", 500.0,
                 880.0)],
        host=[(profview.BUILD_RANGE, 0.0, 410.0),
              ("build.bisim", 0.0, 400.0),
              ("build.upload", 0.0, 100.0),
              ("aten::to", 5.0, 100.0),
              ("build.prepare", 100.0, 150.0),
              ("build.fetch", 300.0, 380.0),
              ("aten::to", 300.0, 330.0),
              ("cudaMemcpyAsync", 360.0, 380.0),
              (profview.BUILD_RANGE, 500.0, 910.0),
              ("build.bisim", 500.0, 900.0),
              ("build.drain", 860.0, 900.0),
              ("aten::stack", 860.0, 870.0)],
        events=[{"name": "build.dispatch"}] * 4
        + [_copy("upload", "device", 3_000_000_000), _copy("drain", "host",
           16), _copy("history", "host", 1_000_000_000)] * 2
        + [_level(0, 1.5), _level(1, 40.0), _level(0, 1.5), _level(1, 41.0)],
        fold_calls=[], fold_launches=0)
    base.update(kw)
    return profview.TraceView(**base)


def read(name, v):
    return registry.metric_reader(name)(v)


def test_readers_on_a_made_up_trace():
    v = view()
    # prepare 50 + fetch 30 + bisim 20, then drain 20: 120 us a 2 builds
    assert read("host.hold_ms", v) == pytest.approx(0.06)
    assert read("copy.h2d_gb", v) == pytest.approx(3.0)
    assert read("copy.d2h_gb", v) == pytest.approx(1.000000016)
    assert read("levels.device_ms", v) == pytest.approx(42.0)


def test_hold_leaves_out_torch_ops_and_the_time_between_builds():
    v = view()
    # the gaps under aten::to (300..330), between the builds (400..500)
    # and after the last (900..1000): idle, but not the program's hold
    idle_us = sum(e - s for s, e in v.gaps())
    assert idle_us == pytest.approx(50 + 30 + 30 + 20 + 100 + 20 + 100)
    assert read("host.hold_ms", v) * 1e3 * v.builds == pytest.approx(120)
    # an op over the whole of build.prepare takes its idle time away
    ops = view(host=v.host + [("aten::min", 100.0, 150.0)])
    assert read("host.hold_ms", ops) == pytest.approx(0.035)
    # a range that holds build.bisim is no op under it
    outer = view(host=v.host + [("aten::outer", 0.0, 1000.0)])
    assert read("host.hold_ms", outer) == pytest.approx(0.06)


def test_readers_return_nothing_without_their_activity():
    v = view()
    # a program without the spans and counters (as before they were added)
    bare = view(host=[r for r in v.host if not r[0].startswith("build.")],
                events=[{"name": "build.dispatch"}] * 4)
    for name in NEW:
        assert read(name, bare) is None
    assert read("host.hold_ms", view(device=[])) is None
    zero = view(events=[_copy("upload", "device", 0),
                        _copy("history", "host", 0)])
    assert read("copy.h2d_gb", zero) is None
    assert read("copy.d2h_gb", zero) is None
    assert read("levels.device_ms", zero) is None


@pytest.mark.parametrize("cell", list(CELLS))
def test_traced_toy_run_counts_the_copies(tmp_path, cell):
    """On the CPU nothing is uploaded and no device is active; the fetch
    and the drains are counted, the same on every build."""
    root = toy_root(tmp_path)
    got = harness.run(cell, 2 ** 31 + 7, 0.05, True, device="cpu", root=root)
    assert got["correct"], got["checks"]
    metrics = got["metrics"]
    assert not {"host.hold_ms", "copy.h2d_gb", "levels.device_ms"} & set(
        metrics)
    cfg = registry.cell(cell, root)
    nodes = 2 ** cfg.config["scale"]
    levels = cfg.traffic["k"] + 1
    # the history (int32 a node a level) and one drained pair a level
    want = (4 * nodes * levels + 8 * levels) / 1e9
    assert metrics["copy.d2h_gb"]["value"] == pytest.approx(want, rel=1e-12)
