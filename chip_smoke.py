#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every kernel of the port from ``src/repro_torch/
             kernels/csrc`` (one ``nvcc`` per source, all started together)
             and print ``-Xptxas -v``'s summary and the card's name and
             power limit;
2. kernels — every kernel against its plain PyTorch version on the card,
             on the layouts the tests use and at the full build's shapes;
             integer outputs, so the tolerance is exact equality;
3. parity  — the port's ``build_bisim`` on the card against the port on
             the CPU (3 modes x fused/staged/with_store), and small builds
             against the exact oracle;
4. full    — the launcher's build of an 8M-node / 64M-requested-edge
             powerlaw graph at k=10 in every mode, with the kernel launch
             counts set to 0 just before and read just after;
5. profile — device time by kernel for the full ``sorted`` build, under
             `torch.profiler`.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Any failure raises and exits non-zero.  It needs one card and imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FULL = dict(nodes=8_000_000, edges=64_000_000, k=10)
PARITY = dict(nodes=200_000, edges=1_000_000, k=10)
DEVICE = "cuda"
MODES = ("sorted", "dedup_hash", "multiset")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(*_build.SIGNATURES)
    seconds = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ptxas = {name: [ln.strip() for ln in _build.ptxas_report(name)
                    .splitlines() if "Used" in ln or "Compiling" in ln]
             for name in _build.SIGNATURES}
    out = {"phase": "build", "seconds": seconds, "nvidia_smi": smi,
           "ptxas": ptxas}
    emit(out)
    return out


def _exact(got, want) -> int:
    """Largest absolute difference of two (hi, lo) lane pairs."""
    return max(int((g - w).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_kernels(full_lanes) -> dict:
    """sig_fold on the card vs sig_fold_plain on the card, exact."""
    import numpy as np
    import torch
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sig_fold import (frontier_sig_fold, sig_fold,
                                              sig_fold_plain)
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    cases, worst = [], 0

    def check(name, args, **kw):
        nonlocal worst
        got = sig_fold(*args, **kw)
        want = sig_fold_plain(*args, **kw)
        torch.cuda.synchronize()
        err = _exact(got, want)
        cases.append({"case": name, "rows": int(got[0].numel()),
                      "max_abs_err": err})
        worst = max(worst, err)

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x)).to(dev, dtype)

    # the blocked layouts of the JAX package's kernel tests
    for n, e, nb, align in [(64, 200, 8, 32), (100, 400, 8, 128),
                            (33, 77, 4, 16), (256, 1024, 16, 64)]:
        g = gen.random_graph(n, e, 3, 2, seed=n + e)
        lay = ops.blocked_csr_layout(g.src, g.dst, g.elabel, g.num_nodes,
                                     nodes_per_block=nb,
                                     edges_per_block_align=align)
        pid_prev = torch.arange(n, device=dev, dtype=torch.int32) % 11
        pid_tgt = pid_prev[t(lay["dst"], torch.int64)]
        args = (t(lay["elabel"]), pid_tgt, t(lay["local_src"]),
                t(lay["valid"], torch.bool))
        check(f"layout n={n} e={e} nb={nb}", args, nodes_per_block=nb,
              edges_per_block=lay["edges_per_block"])
        got = ops.sig_fold_from_layout(
            args[0], t(lay["dst"]), args[2], args[3], pid_prev,
            nodes_per_block=nb, edges_per_block=lay["edges_per_block"],
            num_nodes=n)
        want = ref.sig_fold_ref(t(g.elabel), pid_prev[t(g.dst, torch.int64)],
                                t(g.src), torch.ones(g.num_edges, dtype=torch.bool,
                                                     device=dev), n)
        err = _exact(got, want)
        cases.append({"case": f"layout n={n} vs sig_fold_ref", "max_abs_err": err})
        worst = max(worst, err)
    # empty blocks: rows without edges stay (0, 0)
    lay = ops.blocked_csr_layout(np.array([0, 0, 31]), np.array([1, 2, 3]),
                                 np.zeros(3, np.int32), 32,
                                 nodes_per_block=8, edges_per_block_align=8)
    check("empty blocks", (t(lay["elabel"]), t(lay["dst"]),
                           t(lay["local_src"]), t(lay["valid"], torch.bool)),
          nodes_per_block=8, edges_per_block=lay["edges_per_block"])

    def lanes(n, nb, nlab, npid, *, sort_eb=None, big=False):
        s = rng.integers(-1, nb + 2, n)
        a = rng.integers(0, nlab, n)
        b = rng.integers(0, npid, n)
        if big:  # u32 values >= 2^31 (negative as int32)
            a = a - 2 ** 31 + 5
            b = b + 2 ** 31 - 7
        if sort_eb:  # sorted within each block of sort_eb lanes
            blk = np.arange(n) // sort_eb
            order = np.lexsort((b, a, s, blk))
            s, a, b = s[order], a[order], b[order]
        valid = rng.random(n) < 0.9
        return (t(a.astype(np.int64).astype(np.int32)),
                t(b.astype(np.int64).astype(np.int32)), t(s),
                t(valid, torch.bool))

    check("dedup presorted", lanes(64 * 1024, 32, 3, 8, sort_eb=1024),
          nodes_per_block=32, edges_per_block=1024, dedup=True,
          presorted=True)
    for eb in (256, 4096, 16384):
        check(f"dedup bitonic eb={eb}", lanes(8 * eb, 16, 3, 6),
              nodes_per_block=16, edges_per_block=eb, dedup=True)
    # one repeated triple: each block keeps its own first lane
    same = (t(np.full(1 << 12, 2)), t(np.full(1 << 12, 9)),
            t(np.zeros(1 << 12)), t(np.ones(1 << 12), torch.bool))
    for presorted in (True, False):
        check(f"identical blocks presorted={presorted}", same,
              nodes_per_block=2, edges_per_block=256, dedup=True,
              presorted=presorted)
    check("values >= 2^31", lanes(1 << 16, 64, 4, 50, big=True),
          nodes_per_block=64, edges_per_block=1 << 12, dedup=True,
          presorted=False)
    check("values >= 2^31 multiset", lanes(1 << 16, 64, 4, 50, big=True),
          nodes_per_block=64, edges_per_block=1 << 12)
    # the frontier form: one block of 2^17 lanes, padding seg >= num_sigs
    ns, ne = 4096, 1 << 17
    seg = np.sort(rng.integers(0, ns + 64, ne))
    fr = (t(rng.integers(0, 4, ne)), t(rng.integers(0, 1000, ne)), t(seg),
          t(rng.random(ne) < 0.95, torch.bool))
    for dedup in (False, True):
        got = frontier_sig_fold(*fr, num_sigs=ns, dedup=dedup)
        want = sig_fold_plain(*fr, nodes_per_block=ns, edges_per_block=ne,
                              dedup=dedup, presorted=True)
        err = _exact(got, want)
        cases.append({"case": f"frontier 2^17 dedup={dedup}",
                      "max_abs_err": err})
        worst = max(worst, err)
    # the build's form at full size: one block of every edge
    timing = {}
    for mode, (args, kw) in full_lanes.items():
        check(f"build {mode} E={args[0].numel()}", args, **kw)
        if mode == "sorted":
            timing["ms"] = cuda_ms(lambda: sig_fold(*args, **kw), 20)
            timing["plain_ms"] = cuda_ms(lambda: sig_fold_plain(*args, **kw),
                                         3)
            e, rows = args[0].numel(), kw["nodes_per_block"]
            timing["bound_ms"] = (13 * e + 8 * rows) / HBM_BYTES_PER_S * 1e3
            timing["shape"] = {"lanes": e, "rows": rows, "dedup": True,
                               "presorted": True}
    out = {"phase": "kernels", "kernel": "sig_fold",
           "replaces": "src/repro/kernels/sig_fold.py:113 (_kernel via "
                       "sig_fold :149 and frontier_sig_fold :199)",
           "cases": cases, "mismatches": sum(c["max_abs_err"] != 0
                                             for c in cases),
           "max_abs_err": worst, **timing,
           "bound_by": "bytes", "library_ms": None}
    emit(out)
    if worst:
        raise SystemExit("sig_fold disagrees with its plain version")
    return out


def _same_result(a, b) -> bool:
    import numpy as np
    if not (np.array_equal(a.pids, b.pids) and a.counts == b.counts
            and a.converged_at == b.converged_at
            and a.next_pid == b.next_pid):
        return False
    if a.stores is None or b.stores is None:
        return a.stores is b.stores
    return all(np.array_equal(x.keys, y.keys)
               and np.array_equal(x.pids, y.pids)
               for x, y in zip(a.stores, b.stores))


def phase_parity() -> dict:
    from repro_torch.core import build_bisim, oracle_pids, same_partition
    from repro_torch.graph import generators as gen
    from repro_torch.graph.storage import paper_example_graph
    t0 = time.perf_counter()
    g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3, seed=0)
    runs = []
    for mode in MODES:
        for route in (dict(fused=True), dict(fused=False),
                      dict(fused=False, with_store=True)):
            card = build_bisim(g, PARITY["k"], mode=mode, device=DEVICE,
                               **route)
            cpu = build_bisim(g, PARITY["k"], mode=mode, device="cpu",
                              **route)
            runs.append({"mode": mode, **route, "counts": card.counts,
                         "equal": _same_result(card, cpu)})
    oracle = []
    for name, small in (("paper_example", paper_example_graph()),
                        ("random", gen.random_graph(300, 1200, 4, 3,
                                                    seed=7))):
        for mode in MODES:
            res = build_bisim(small, 6, mode=mode, early_stop=False,
                              device=DEVICE)
            ora = oracle_pids(small, 6, counting=(mode == "multiset"),
                              early_stop=False)
            oracle.append({"graph": name, "mode": mode,
                           "equal": len(ora) == res.pids.shape[0] and all(
                               same_partition(res.pids[j], ora[j])
                               for j in range(len(ora)))})
    out = {"phase": "parity", "graph": {"generator": "powerlaw",
                                        "nodes": g.num_nodes,
                                        "edges": g.num_edges},
           "card_vs_cpu": runs, "oracle": oracle,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not all(r["equal"] for r in runs + oracle):
        raise SystemExit("card build differs from the CPU build or oracle")
    return out


def _refines(fine, coarse) -> bool:
    """Vectorised `refines`: every fine block lies in one coarse block."""
    import numpy as np
    pairs = np.unique(fine.astype(np.int64) << 32 | coarse.astype(np.int64))
    return pairs.shape[0] == np.unique(fine).shape[0]


def _build_lanes(g, mode):
    """The lanes the build's first iteration hands to the kernel."""
    import torch
    from repro_torch.core import signatures as sig
    dev = torch.device(DEVICE)
    labels, src, dst, elabel = (torch.from_numpy(x).to(dev) for x in (
        g.node_labels, g.src, g.dst, g.elabel))
    pid0, _ = sig.dense_rank_ints(labels)
    a, b, s, valid, dedup = sig.fold_lanes(
        src, dst, elabel, pid0, num_nodes=g.num_nodes, mode=mode,
        elabel_range=(int(g.elabel.min()), int(g.elabel.max())))
    return (a, b, s, valid), dict(nodes_per_block=g.num_nodes,
                                  edges_per_block=a.numel(), dedup=dedup,
                                  presorted=True)


def phase_full(args, g, gen_seconds) -> dict:
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.kernels.sig_fold import sig_fold
    from repro_torch.launch import bisim as launcher
    card = torch.cuda.get_device_properties(0).total_memory
    runs, results = [], {}
    for mode in MODES:
        args.mode = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sig_fold.launches = 0
        with obs.tracing() as tracer:
            res, wall = launcher.run_build(args, g)
        launches = sig_fold.launches
        launcher.report(args, res, wall)
        steps = sum(e["attrs"].get("what") == "step"
                    for e in tracer.find_events("build.dispatch"))
        peak = torch.cuda.max_memory_allocated()
        runs.append({
            "mode": mode, "iterations_executed": steps,
            "counts": res.counts, "converged_at": res.converged_at,
            "wall_s": wall, "graph_gen_s": gen_seconds,
            "iteration_ms": [s.seconds * 1e3 for s in res.stats],
            "syncs": len(tracer.find_events("build.sync")),
            "peak_bytes": peak, "peak_share": peak / card,
            "sig_fold_launches": launches})
        results[mode] = res
        if launches != steps or steps == 0:
            raise SystemExit(f"{mode}: {launches} sig_fold launches for "
                             f"{steps} iterations")
        pids = res.pids
        if pids.shape != (len(res.counts), g.num_nodes) or any(
                int(pids[j].min()) < 0 or int(pids[j].max()) >= c
                for j, c in enumerate(res.counts)):
            raise SystemExit(f"{mode}: malformed pid history")
        if any(b < a for a, b in zip(res.counts, res.counts[1:])):
            raise SystemExit(f"{mode}: partition counts shrink")
    ok = (np.array_equal(results["sorted"].pids, results["dedup_hash"].pids)
          and all(_refines(results["multiset"].pid_at(j),
                           results["sorted"].pid_at(j))
                  for j in range(FULL["k"] + 1)))
    out = {"phase": "full", "graph": {"generator": "powerlaw",
                                      "nodes": g.num_nodes,
                                      "edges_requested": FULL["edges"],
                                      "edges": g.num_edges},
           "k": FULL["k"], "runs": runs, "card_bytes": card,
           "sorted_equals_dedup_hash_and_multiset_refines": ok}
    emit(out)
    if not ok:
        raise SystemExit("modes disagree at full size")
    return out


def phase_profile(args, g) -> dict:
    """Where the device time of the full ``sorted`` build goes: kernel
    time by name under `torch.profiler`, and the busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import bisim as launcher
    args.mode = "sorted"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = launcher.run_build(args, g)
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        kernels.append({"kernel": ev.key[:90], "ms": ms, "calls": ev.count})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(k["ms"] for k in kernels)
    out = {"phase": "profile", "mode": "sorted", "wall_ms": wall * 1e3,
           "device_ms": device_ms, "busy_share": device_ms / (wall * 1e3),
           "top": kernels[:12]}
    emit(out)
    if not kernels:
        raise SystemExit("the profiler saw no device time")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import bisim as launcher

    phase_build()
    args = launcher.build_parser().parse_args([
        "--generator", "powerlaw", "--nodes", str(FULL["nodes"]),
        "--edges", str(FULL["edges"]), "--k", str(FULL["k"]),
        "--mode", "sorted", "--device", DEVICE])
    t0 = time.perf_counter()
    g = launcher.make_graph(args)
    gen_seconds = time.perf_counter() - t0
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges "
          f"({gen_seconds:.1f} s to generate)", flush=True)
    kern = phase_kernels({m: _build_lanes(g, m) for m in MODES})
    phase_parity()
    full = phase_full(args, g, gen_seconds)
    phase_profile(args, g)
    emit({"kernels": [{
        "name": "sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:113",
        "launches": full["runs"][0]["sig_fold_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
