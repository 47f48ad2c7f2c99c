"""One run of one cell of the port's benchmark.

Set-up makes the cell's graph on the card from the seed, copies it to
the host once as the program's `Graph`, and runs one warm-up build (which
builds or loads the ``sig_fold`` kernel).  The window is a closed loop of
one client: `repro_torch.core.partition.build_bisim` on that graph, the
next build started once the last has returned its pid history and
``torch.cuda.synchronize()`` has come back, until ``--seconds`` have
passed.  After the window, the graph is made again from the seed and the
plain reference (`bench/reference/bisim.py`) works out its partition;
`bench/checks.py` judges the window's outputs against it.

With ``--trace 1`` the window runs under ``torch.profiler`` with the
program's tracer installed and the fold's Python entry wrapped, and the
line carries the cell's per-layer metrics (`bench/metrics/`) instead of
its end-to-end ones.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from bench import checks, profview, registry, roofline
from bench.graphs import COLUMNS, fingerprint
from bench.reference import bisim as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started: its start time in
    ``/proc/self/stat`` against ``CLOCK_BOOTTIME`` (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def forbidden(modules) -> list:
    """Top-level names among ``modules`` (names of loaded modules) that the
    port must never load, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _sync(dev):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def set_up(cell, seed: int, dev, mode: str, k: int, early_stop: bool,
           root=registry.ROOT):
    """The program's host `Graph` of the cell, after one warm-up build;
    with the set-up's parts in seconds and the graph's fingerprint."""
    from repro_torch.core import partition
    from repro_torch.graph.storage import Graph
    from repro_torch.kernels import _build
    parts = {"start_s": process_age_s()}
    sync = _sync(dev)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        sync()
    parts["device_init_s"] = process_age_s() - parts["start_s"]
    gen = registry.generator(cell.config["generator"], root)
    t = time.perf_counter()
    cols = gen.generate(cell.config, seed, dev)
    sync()
    parts["generate_s"] = time.perf_counter() - t
    fp = fingerprint(cols)
    t = time.perf_counter()
    graph = Graph(**{c: cols[c].cpu().numpy() for c in COLUMNS})
    parts["host_copy_s"] = time.perf_counter() - t
    del cols
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    partition.build_bisim(graph, k, mode=mode, early_stop=early_stop,
                          device=dev)
    sync()
    parts["warmup_s"] = time.perf_counter() - t
    parts["compile_s"] = _build.BUILD_SECONDS.get("sig_fold", 0.0)
    return graph, parts, fp


def closed_loop(graph, seconds: float, dev, build, sampler, traced: bool):
    """Builds back to back for ``seconds``: (each build's block counts,
    the window's wall seconds)."""
    sync = _sync(dev)
    outcomes, ends = [], []
    span = (lambda: torch.profiler.record_function(profview.BUILD_RANGE)
            ) if traced else contextlib.nullcontext
    t0 = time.perf_counter()
    while True:
        with span():
            res = build(graph)
            sync()
        t = time.perf_counter()
        outcomes.append(list(res.counts))
        ends.append(t)
        sampler.offer(res.pids)
        del res
        if t - t0 >= seconds:
            each = np.diff([t0] + ends)
            log("build seconds (first, min, median, max): "
                f"{each[0]:.4f} {each.min():.4f} {np.median(each):.4f} "
                f"{each.max():.4f}")
            return outcomes, t - t0


@contextlib.contextmanager
def fold_calls(calls: list):
    """Record (lanes, rows) of each fold the build makes, by wrapping the
    fold's Python entry, which `core.signatures` looks up at each call."""
    from repro_torch.kernels import sig_fold as sf
    inner = sf.frontier_sig_fold

    def counted(elabel, pid_tgt, seg, valid, *, num_sigs, **kw):
        if elabel.numel():
            calls.append((elabel.numel(), num_sigs))
        return inner(elabel, pid_tgt, seg, valid, num_sigs=num_sigs, **kw)
    sf.frontier_sig_fold = counted
    try:
        yield
    finally:
        sf.frontier_sig_fold = inner


END_TO_END = {
    "build_ms": lambda r: 1e3 * r["window_s"] / r["builds"],
    "device_bytes_per_edge": lambda r: r["window_peak"] / r["edges"],
    "setup_s": lambda r: r["setup_s"],
}


def per_layer(cell, view, root) -> dict:
    """The cell's per-layer metrics that its readers found in ``view``."""
    metrics = {}
    for m in cell.per_layer:
        value = registry.metric_reader(m["name"], root)(view)
        if value is None:
            log(f"per-layer metric {m['name']}: nothing to read")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def against_reference(cfg, seed, k, early_stop, dev, fp, outcomes, sampler,
                      root):
    """(checks, failed builds, inputs equal): the window's outputs judged
    against the reference's partition of the graph made again from the
    seed."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cols = registry.generator(cfg["generator"], root).generate(cfg, seed, dev)
    same_graph = fingerprint(cols) == fp
    ref = reference.partition(cols, k, early_stop=early_stop)
    del cols
    chk, failed = checks.judge(outcomes, sampler.kept, ref, dev)
    log(f"builds {len(outcomes)}; reference counts {ref.counts}, "
        f"converged_at {ref.converged_at}; judged {len(sampler.kept)} pid "
        f"histories (builds {[i for i, _ in sampler.kept]})")
    if not same_graph:
        log("the graph made again from the seed is not the one the program "
            "was given: nothing to compare against")
    return chk, failed, same_graph


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", mode=None, root=registry.ROOT) -> dict:
    """The result line of one run (``mode`` overrides the configuration's
    signature mode, for the control; ``root`` holds `BENCHMARK.json` and
    ``bench/``)."""
    from repro_torch.core import partition
    from repro_torch.kernels import sig_fold as sf
    from repro_torch.obs import tracer as obs
    cell = registry.cell(cell_name, root)
    cfg, tr = cell.config, cell.traffic
    if tr.get("clients", 1) != 1 or tr.get("loop", "closed") != "closed":
        raise ValueError("the harness drives a closed loop of one client")
    k, early_stop = int(tr["k"]), bool(tr.get("early_stop", True))
    mode = mode or cfg["mode"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    graph, parts, fp = set_up(cell, seed, dev, mode, k, early_stop, root)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def build(g):
        return partition.build_bisim(g, k, mode=mode, early_stop=early_stop,
                                     device=dev)
    sampler = checks.Sampler(seed)
    calls, tracer, prof = [], None, None
    with contextlib.ExitStack() as stack:
        if trace:
            tracer = stack.enter_context(obs.tracing())
            stack.enter_context(fold_calls(calls))
            launches0 = sf.sig_fold.launches
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])]))
        setup_s = process_age_s()
        outcomes, window_s = closed_loop(graph, seconds, dev, build, sampler,
                                         trace)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = {"builds": len(outcomes), "window_s": window_s,
              "window_peak": window_peak, "edges": graph.num_edges,
              "setup_s": setup_s}
    parts["setup_s"] = setup_s
    del graph

    result = {"correct": False, "attempted": len(outcomes), "failed": 0}
    if trace:
        view = profview.from_profiler(
            prof, len(outcomes), events=list(tracer.events),
            fold_calls=calls, fold_launches=sf.sig_fold.launches - launches0)
        del prof
        result["metrics"] = per_layer(cell, view, root)
    else:
        result["metrics"] = {
            m["name"]: {"value": END_TO_END[m["name"]](record),
                        "unit": m["unit"]} for m in cell.end_to_end}
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": max(setup_peak, window_peak),
        "power_limit_w": roofline.power_limit_w() if cuda else None}
    if trace:
        result["device"].update(busy_s=view.busy_s(), window_s=view.window_s)
        result["breakdown"] = view.breakdown()
    result["setup_parts"] = parts

    t = time.perf_counter()
    chk, failed, same_graph = against_reference(
        cfg, seed, k, early_stop, dev, fp, outcomes, sampler, root)
    parts["reference_s"] = time.perf_counter() - t
    log("set-up parts: " + json.dumps(parts))
    result["correct"] = (checks.passed(chk) and bool(sampler.kept)
                         and same_graph)
    result["failed"] = failed
    result["checks"] = chk
    for name, c in chk.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = registry.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden(sys.modules)  # the window has closed
    if found:
        log(f"the run loaded {found}: no result")
        return 3
    print(json.dumps(result), flush=True)
    return 0
