#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every kernel of the port from ``src/repro_torch/
             kernels/csrc`` (one ``nvcc`` per source, all started together)
             and print ``-Xptxas -v``'s summary and the card's name and
             power limit;
2. kernels — every kernel against its plain PyTorch version on the card,
             on the layouts the tests use and at the main paths' shapes
             (``sig_fold``, then ``chunk_sig_fold`` at 2^10..2^22 lanes);
             integer outputs, so the tolerance is exact equality;
3. parity  — the port's ``build_bisim`` on the card against the port on
             the CPU (3 modes x fused/staged/with_store), and small builds
             against the exact oracle;
4. oocore_parity — the port's ``build_bisim_oocore`` on the card against
             the port on the CPU (3 modes, plus a checkpointed build killed
             at a fault point and resumed): pid files, counts,
             ``converged_at`` and ``IOStats`` equal;
5. full    — the launcher's build of an 8M-node / 64M-requested-edge
             powerlaw graph at k=10 in every mode, with the kernel launch
             counts set to 0 just before and read just after;
6. profile — device time by kernel for the full ``sorted`` build, under
             `torch.profiler`;
7. oocore  — the launcher's ``--oocore`` build of the same graph
             (``sorted``, k=10, 2^20-edge chunks), its ``chunk_sig_fold``
             count set to 0 just before and read just after, with the
             fold's and the uploads' CUDA-event time; its counts and last
             partition must equal the in-memory build's.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Any failure raises and exits non-zero.  It needs one card and imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
FULL = dict(nodes=8_000_000, edges=64_000_000, k=10)
PARITY = dict(nodes=200_000, edges=1_000_000, k=10)
OOCORE = dict(chunk_edges=1 << 20, parity_chunk_edges=1 << 16)
WORKDIR = ROOT / "build" / "oocore-smoke"  # git-ignored; removed at exit
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


def _chunk_lanes(rng, n, chunk_edges, layout, big):
    """One chunk as the out-of-core build lays it out: ``n`` lanes of a
    (src, eLabel, pId)-sorted stream with dense ascending seg, padded to
    ``chunk_edges`` with seg = chunk_edges - 1 and valid False.  Layouts:
    ``distinct`` (every lane its own segment), ``mixed`` (duplicate
    triples, segments of a few lanes), ``hub`` (one segment)."""
    import numpy as np
    import torch
    if layout == "distinct":
        src = np.arange(n)
    elif layout == "hub":
        src = np.zeros(n, np.int64)
    else:
        src = np.sort(rng.integers(0, max(n // 4, 1), n))
    a = rng.integers(0, 3, n)
    b = rng.integers(0, 5 if layout != "distinct" else 1 << 20, n)
    if big:  # u32 values >= 2^31 (negative as int32)
        a, b = a - 2 ** 31 + 5, b + 2 ** 31 - 7
    order = np.lexsort((b, a, src))
    src, a, b = src[order], a[order], b[order]
    new = np.ones(n, bool)
    new[1:] = src[1:] != src[:-1]
    lanes = np.zeros((3, chunk_edges), np.int32)
    lanes[0, :n] = a.astype(np.int64).astype(np.int32)
    lanes[1, :n] = b.astype(np.int64).astype(np.int32)
    lanes[2, :n] = np.cumsum(new) - 1
    lanes[2, n:] = chunk_edges - 1
    dev = torch.device(DEVICE)
    lanes = torch.from_numpy(lanes).to(dev)
    return (lanes[0], lanes[1], lanes[2],
            torch.arange(chunk_edges, device=dev) < n)


def phase_chunk_kernels() -> dict:
    """chunk_sig_fold on the card vs chunk_sig_fold_plain on the card,
    exact, over chunk sizes 2^10..2^22; timed at the build's 2^20."""
    import numpy as np
    import torch
    from repro_torch.kernels.sig_fold import (chunk_sig_fold,
                                              chunk_sig_fold_plain)
    rng = np.random.default_rng(1)
    cases, worst, timing = [], 0, {}
    for log2 in (10, 16, 20, 22):
        ce = 1 << log2
        shapes = [("full", ce, layout, layout != "distinct")
                  for layout in ("distinct", "mixed", "hub")]
        shapes += [("partial", ce - ce // 7 - 1, "mixed", True),
                    ("partial", ce // 3, "hub", False),
                    ("all-invalid", 0, "mixed", False)]
        for fill, n, layout, big in shapes:
            lanes = _chunk_lanes(rng, n, ce, layout, big)
            for dedup, keep0 in ((True, True), (True, False),
                                 (False, True), (False, False)):
                kw = dict(num_segments=ce, dedup=dedup)
                got = chunk_sig_fold(*lanes, keep0, **kw)
                want = chunk_sig_fold_plain(*lanes, keep0, **kw)
                torch.cuda.synchronize()
                err = _exact(got, want)
                cases.append({"case": f"2^{log2} {fill} {layout} big={big} "
                                      f"dedup={dedup} keep0={keep0}",
                              "max_abs_err": err})
                worst = max(worst, err)
            if log2 == 20 and fill == "full" and layout == "mixed":
                kw = dict(num_segments=ce, dedup=True)
                timing["ms"] = cuda_ms(
                    lambda: chunk_sig_fold(*lanes, True, **kw), 20)
                timing["plain_ms"] = cuda_ms(
                    lambda: chunk_sig_fold_plain(*lanes, True, **kw), 5)
                timing["bound_ms"] = ((13 * ce + 8 * ce) / HBM_BYTES_PER_S
                                      * 1e3)
                timing["shape"] = {"lanes": ce, "num_segments": ce,
                                   "dedup": True, "layout": layout}
    out = {"phase": "kernels", "kernel": "chunk_sig_fold",
           "replaces": "src/repro/kernels/sig_fold.py:221 (_chunk_kernel "
                       "via chunk_sig_fold :279)",
           "cases": len(cases),
           "mismatches": [c for c in cases if c["max_abs_err"]],
           "max_abs_err": worst, **timing, "bound_by": "bytes",
           "library_ms": None}
    emit(out)
    if worst:
        raise SystemExit("chunk_sig_fold disagrees with its plain version")
    return out


def _same_oocore(a, b) -> bool:
    import numpy as np
    return (a.counts == b.counts and a.converged_at == b.converged_at
            and a.io.to_dict() == b.io.to_dict()
            and len(a.pid_paths) == len(b.pid_paths)
            and all(np.array_equal(np.load(x), np.load(y))
                    for x, y in zip(a.pid_paths, b.pid_paths)))


def phase_oocore_parity() -> dict:
    """The out-of-core build on the card equals the CPU's, in every mode,
    and a checkpointed card build killed at a fault point resumes to the
    CPU's clean result."""
    import numpy as np
    from repro_torch.core import faults
    from repro_torch.exmem import build_bisim_oocore
    from repro_torch.graph import generators as gen
    from repro_torch.kernels.sig_fold import chunk_sig_fold
    t0 = time.perf_counter()
    g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3, seed=0)
    k, ce = PARITY["k"], OOCORE["parity_chunk_edges"]
    runs, cpu_sorted = [], None
    for mode in MODES:
        before = chunk_sig_fold.launches
        card = build_bisim_oocore(g, k, mode=mode, chunk_edges=ce,
                                  workdir=str(WORKDIR / f"card-{mode}"),
                                  device=DEVICE)
        launches = chunk_sig_fold.launches - before
        cpu = build_bisim_oocore(g, k, mode=mode, chunk_edges=ce,
                                 workdir=str(WORKDIR / f"cpu-{mode}"),
                                 device="cpu")
        runs.append({"mode": mode, "counts": card.counts,
                     "converged_at": card.converged_at,
                     "io": card.io.to_dict(), "launches": launches,
                     "equal": _same_oocore(card, cpu) and launches > 0})
        if mode == "sorted":
            cpu_sorted = cpu
    # checkpoint/resume on the card: count the fault points of a clean
    # checkpointed build, kill a second one halfway, resume it, and hold
    # it to the CPU's clean build (IOStats differ by design: a resumed
    # build also pays its recovery scans)
    kw = dict(chunk_edges=ce, io_threads=0, checkpoint=True, device=DEVICE)
    with faults.install_fault_plan(faults.FaultPlan()) as seen:
        build_bisim_oocore(g, k, workdir=str(WORKDIR / "ckpt-clean"), **kw)
    kill_at = seen.points_seen // 2
    crashed = False
    with faults.install_fault_plan(faults.FaultPlan(crash_at=kill_at)):
        try:
            build_bisim_oocore(g, k, workdir=str(WORKDIR / "ckpt"), **kw)
        except faults.InjectedCrash:
            crashed = True
    resumed = build_bisim_oocore(g, k, workdir=str(WORKDIR / "ckpt"),
                                 resume=True, **kw)
    resume_equal = (crashed and resumed.counts == cpu_sorted.counts
                    and resumed.converged_at == cpu_sorted.converged_at
                    and len(resumed.pid_paths) == len(cpu_sorted.pid_paths)
                    and all(np.array_equal(np.load(a), np.load(b))
                            for a, b in zip(resumed.pid_paths,
                                            cpu_sorted.pid_paths)))
    out = {"phase": "oocore_parity",
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           "k": k, "chunk_edges": ce, "card_vs_cpu": runs,
           "checkpoint": {"fault_points": seen.points_seen,
                          "killed_at": kill_at, "crashed": crashed,
                          "resumed_counts": resumed.counts,
                          "equal_to_cpu_clean": resume_equal},
           "seconds": time.perf_counter() - t0}
    emit(out)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    if not (all(r["equal"] for r in runs) and resume_equal):
        raise SystemExit("card oocore build differs from the CPU's")
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
    return out, results["sorted"]


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


def _timed(fn, log: list):
    """``fn`` with CUDA events recorded around each call into ``log``."""
    import torch

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((start, end))
        return out
    return timed


def phase_oocore(args, g, inmem) -> dict:
    """The launcher's ``--oocore`` build at full width.  The fold wrapper
    and the chunk upload of `repro_torch.exmem.build` are wrapped with
    CUDA events for the run (the wrapped kernel still counts its own
    launches); the result must equal the in-memory ``sorted`` build."""
    import argparse
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.exmem import build as oocore
    from repro_torch.kernels.sig_fold import chunk_sig_fold
    from repro_torch.launch import bisim as launcher
    args = argparse.Namespace(**{
        **vars(args), "oocore": True, "mode": "sorted",
        "chunk_edges": OOCORE["chunk_edges"], "io_threads": 1,
        "workdir": str(WORKDIR / "full")})
    fold_ev, upload_ev = [], []
    saved = oocore.chunk_sig_fold, oocore._upload
    oocore.chunk_sig_fold = _timed(saved[0], fold_ev)
    oocore._upload = _timed(saved[1], upload_ev)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        chunk_sig_fold.launches = 0
        with obs.tracing() as tracer:
            res, wall = launcher.run_build(args, g)
        launches = chunk_sig_fold.launches
    finally:
        oocore.chunk_sig_fold, oocore._upload = saved
    peak = torch.cuda.max_memory_allocated()
    launcher.report(args, res, wall)
    torch.cuda.synchronize()
    folds = len(tracer.find("build.fold"))
    phases = obs.MetricsReport.from_tracer(tracer).as_dict()["phases"]
    last = np.load(res.pid_paths[-1])
    same_last = (np.unique(last.astype(np.int64) << 32
                           | inmem.pids[-1].astype(np.int64)).shape[0]
                 == np.unique(last).shape[0]
                 == np.unique(inmem.pids[-1]).shape[0])
    out = {"phase": "oocore", "mode": "sorted",
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges_requested": FULL["edges"],
                     "edges": g.num_edges},
           "k": FULL["k"], "chunk_edges": args.chunk_edges,
           "io_threads": args.io_threads, "wall_s": wall,
           "level_s": [st.seconds for st in res.stats],
           "counts": res.counts, "converged_at": res.converged_at,
           "io": res.io.to_dict(), "aio": res.aio.as_dict(),
           "chunk_sig_fold_launches": launches, "chunks_folded": folds,
           "fold_event_ms": sum(a.elapsed_time(b) for a, b in fold_ev),
           "upload_event_ms": sum(a.elapsed_time(b) for a, b in upload_ev),
           "peak_bytes": peak,
           "span_total_s": {name: ph["total_s"]
                            for name, ph in phases.items()},
           "counts_equal_inmemory": res.counts == inmem.counts,
           "last_level_same_partition": bool(same_last)}
    emit(out)
    res.cleanup()
    if launches == 0 or launches != folds:
        raise SystemExit(f"oocore: {launches} chunk_sig_fold launches for "
                         f"{folds} chunks folded")
    if not (out["counts_equal_inmemory"] and same_last):
        raise SystemExit("oocore build differs from the in-memory build")
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
    try:
        kern = phase_kernels({m: _build_lanes(g, m) for m in MODES})
        chunk = phase_chunk_kernels()
        phase_parity()
        phase_oocore_parity()
        full, inmem = phase_full(args, g, gen_seconds)
        phase_profile(args, g)
        ooc = phase_oocore(args, g, inmem)
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    emit({"kernels": [{
        "name": "sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:113",
        "launches": full["runs"][0]["sig_fold_launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "chunk_sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunk_sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:221",
        "launches": ooc["chunk_sig_fold_launches"],
        "max_abs_err": chunk["max_abs_err"], "ms": chunk["ms"],
        "plain_ms": chunk["plain_ms"], "bound_ms": chunk["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
