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
             integer outputs, so the tolerance is exact equality.  Each
             fold is timed three ways: ``kernel_ms`` (its own device time
             by name under `torch.profiler`, the output's memset apart),
             ``ms`` (the wrapper a call, CUDA events) and ``host_us`` (the
             host's time a wrapper call): ``sig_fold`` at the full build's
             lanes in all three modes, ``chunk_sig_fold`` at 2^20 lanes
             into 2^20 rows and at the out-of-core build's mean chunk;
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
             partition must equal the in-memory build's;
7a. distributed_parity — `core.build_bisim_distributed` on the parity
             graph at k=10, every mode with both rankings, in three
             groups: one rank on the card under NCCL (in this process),
             and eight gloo ranks (``--worker dist_parity`` processes)
             building on the CPU and then sharing the card; card D=8 =
             CPU D=8 and card D=1 ``allgather`` = CPU D=8 ``allgather``
             bit for bit, every run's counts the single-card build's and
             each level its partition, ``fold_flat`` once an iteration on
             the card; one line a group (per run: rank 0's per-iteration
             ms; every rank's collective ms and bytes a rank-iteration by
             CUDA events around the build's collectives, peak card memory
             and ``fold_flat`` launches);
7b. distributed — the launcher's ``--distributed`` build of the full
             graph (saved once under ``build/dist-smoke/``, read with
             ``--graph``) under ``python -m torch.distributed.run
             --standalone``: one rank under NCCL (``allgather``) and four
             gloo ranks sharing the card (``bucketed``), each rank a
             ``--worker dist_launch`` process with its ``sig_fold`` count
             set to 0 just before the launcher runs and read just after;
             counts equal and the same partition at every level as the
             in-memory ``sorted`` build; one line a run, as 7a's;
7c. maintenance — Algorithms 2-4 on the same graph at k=10, ``sorted``
             and ``multiset``: a maintainer with device propagation on
             the card and one on the numpy host path take the same ops
             (1 and 1,000 random edge inserts, and 100,000 in
             ``multiset``, 1,000 existing edges again, DELETE_NODE on
             a node, compact) and must agree
             bit for bit after each; one line an op (frontier and changed
             nodes a level, rebuilt, device and host walls, fold launches,
             store sizes and bytes, peak memory); at the end equal stores
             and, at every level, the partition of a fresh card build;
             it fails unless some op propagated on the device through the
             kernel without the §4.2 rebuild;
7d. frontier_kernels — ``frontier_sig_fold`` against its plain version
             and timed at the largest and the median batch the
             maintenance phase folded, both dedup settings (run once the
             workers of 7e, 7g-7i have ended, alone on the card);
7e. ooc_maintenance_parity — run by the parity worker, a process of
             this script beside 7c, 7f and 7h-7i, before 7g:
             `exmem.OocBackend` maintenance of the parity graph at k=10 (``sorted``, ``multiset``; 2^16-edge
             chunks, stores that spill at 2^14 entries) on the card with
             device propagation, on the card with host propagation and on
             the CPU, fed the same ops (1 and 1,000 random inserts, 100
             edges deleted, 10 new nodes, DELETE_NODE, compact, Change-k
             10 -> 6 -> 10): after every op equal pid files, next_pid,
             tombstones, ``IOStats`` and store states; then a WAL'd card
             run snapshotted after op 2, its fault points counted, killed
             at a point drawn from ``default_rng(0)``, restored and
             finished, must give the never-killed pid history;
7f. ooc_maintenance — the same 8M-node graph maintained out of core at
             k=4 (its partition stops changing at level 4), ``sorted``,
             2^20-edge chunks, with the write-ahead log, beside an
             in-memory maintainer on the card: the build (its
             ``chunk_sig_fold`` launches equal the chunks folded),
             100,000 random inserts, a snapshot,
             1,000 inserts, a crash (no close) and recovery with device
             propagation (pid files bit-identical), 1,000 more inserts;
             one line an op (frontier and changed nodes a level, rebuilt,
             out-of-core and in-memory walls, the ``IOStats`` delta,
             ``frontier_sig_fold`` launches, spilled runs, peak card
             memory); every level the in-memory partition after each op
             and a fresh card build's at the end; it fails unless some op
             went through ``frontier_sig_fold`` without a rebuild;
7g. quotient_parity — run by the parity worker after 7e: the quotient
             engine (`repro_torch.quotient`) on the
             parity graph at k=10 in every mode: `QuotientService`
             materializes the card maintainer's partition, and the card
             engine, a CPU engine over the same index, `eval_ref` and
             `eval_brute` on the original graph agree on a seeded query
             suite at levels 1, 5 and 10; then (``sorted``) 1,000
             inserts, DELETE_NODE, compact and Change-k 10 -> 6 through
             the service, after each the same agreement, and a patched
             index answers as a freshly materialized one;
7h. quotient — the full graph's quotient at k=4 (``sorted``, an
             in-memory card maintainer, 2^20-row sort budgets), run by a
             worker process of this script beside 7c and 7e-7g: blocks
             and edges a level, the materialize wall and `IOStats`, the
             engine's device bytes; every answer of 32 path queries and
             64 point lookups against `eval_ref` and 16 against
             `eval_brute`; then 1,000 inserts absorbed by
             the service (patch ms, levels touched, ``sig_fold`` and
             ``frontier_sig_fold`` launches) and the queries again on
             the patched index (not against `eval_ref`: that round is
             cut for time); last, once no other process uses the
             card, the queries once more through the engine, its waves
             and hops timed by CUDA events and its own spans, and its
             device->host copies a wave;
7i. stream — ``serve-updates`` on the parity graph (120 ops, the
             launcher's batches of 32, k=10, ``--oocore --wal``) in two
             worker processes of this script, started after phase 2
             (beside 3-7b and then 7c-7h): the card's
             ``--kill-at-op 72`` crash
             drill, whose uninterrupted run is the stream straight
             through (updates/s, batches, snapshots, staleness against
             its bound, epoch, ``chunk_sig_fold`` and
             ``frontier_sig_fold`` launches) and whose recovered history
             is bit-identical, and the CPU; both card histories equal
             the CPU's;
7j. sharded_train_parity — eight gloo ranks sharing the card
             (``--worker sharded`` processes with torchrun's variables,
             started with 7h's workers): gemma2's smoke config in f32
             (weight matrices at std 1/sqrt(d_in)) takes one step of
             `train.make_train_step` over a 4x2 ``(data, model)``
             `DeviceMesh`; the gradients AdamW gets, each leaf's within
             1e-4 of its max |g| of the one-rank step's on the card, the
             grad norm within 1e-4 (relative), the loss and every leaf
             within 1e-4; each rank's launches of both f32 attention
             kernels (on its local heads, the one-rank counts), the
             shards the kernels got, and every gradient in its weight's
             placements; then the same step over a 2x4 mesh (2 kv heads
             over a 4-way model axis: one kv head a rank, dk/dv a Partial
             sum), its gradients, grad norm and loss held the same way;
             then an MoE layer (`MOE_A2A`: the reference test's, 4
             experts, top-2) over a (2, 2, 2) pod x data x model mesh
             through `moe._apply_moe_a2a` (its all-to-alls c10d calls on
             CUDA tensors, DTensor's collectives staged) against the
             dense dispatch on the card: values within 2e-4, gradients
             within 2e-3;
7k. dryrun — `launch.dryrun` in a worker process (host work, fake
             tensors over a fake group of 256 ranks): gemma2-9b x
             ``train_4k`` and x ``decode_32k``, mamba2-780m and zamba2-7b
             x ``long_500k`` (the decode at 524,288 positions that only
             the sub-quadratic architectures trace) and the paper's
             bisim iteration (``sorted``, both rankings) on the
             single-pod mesh; per cell ``DRY-RUN PASS``, per-rank peak
             bytes, the H100 roofline's three terms, the dominant one and
             the trace seconds;
8. attention — ``flash_attention`` against its plain PyTorch version on
             the card (2e-5 in f32, 2e-2 in bf16) on the JAX package's
             attention test cases, odd lengths, and the bf16 (wgmma)
             kernel at every head_dim, ragged lengths, GQA groups 1/2/8,
             window and softcap on and off and a [B, S, H, D] view; then
             gemma2-9b's prefill shape (bf16, head_dim 256, 8192 tokens,
             causal; softcap 50 with and without the 4096 window, and
             without softcap), timed beside its bound and beside
             `scaled_dot_product_attention` (without softcap a yardstick
             of the same function, with it of a neighbouring one; the
             port never calls it), with the kernel's own time under
             `torch.profiler`, the time of 20 calls in a row by CUDA
             events and the host's time a call; then minicpm3-4b's MLA
             prefill (bf16, 40/40 heads, q/k head_dim 96 = 64 nope + 32
             rope, v head_dim 64, 8192 tokens, causal) and
             deepseek-v2-lite's (16/16 heads, q/k 192 = 128 nope + 64
             rope, v 128) the same way, each bound at 2 (D + Dv) flops a
             visible pair and SDPA on the backends that take a v head_dim
             of its own, and the three MLA pairs (96/64, 24/16, 192/128)
             in both dtypes against the plain version; zamba2-7b's shared
             block's prefill the same way (32/32 heads of 112, padded to
             128 columns in the bf16 kernel; SDPA as it picks its
             backend) and the (112, 112) cases; then seamless-m4t's heads
             (16/16 of 64, non-causal, both dtypes, SDPA with is_causal
             off): the encoder's 4,096 frames, prefill_32k's 32,768
             decoder positions over them in bf16 (8,192 in f32; the plain
             version on slices of 8,192 rows) and a decode step's 4 rows
             of one query, each output within 1e-2 (bf16) or 1e-4 (f32)
             of its max |o| and each row's ``lse`` within 1e-3 / 1e-4 of
             its max |lse| (one key tile of 32 missed moves an lse by
             3e-2, which a bf16 output's bar alone would not see), and
             the seconds these cases take; each f32 row also beside
             the 3xTF32 bound (its bound) and the CUDA-core one, printed
             with both shares; prints the attention libraries' ``-Xptxas
             -v`` lines, a register/spill/wgmma/mma.sync count of each
             kernel's SASS and the route each dtype takes;
8a. attention_bwd — ``flash_attention_bwd`` against its plain version
             (`_bwd_rule`'s port) on the card on the cases of
             `tests/test_torch_kernels_gpu.py`, each dtype through its
             route, recorded (bf16 the wgmma kernel within 2e-2 of each
             output's max |x|, f32 the 3xTF32 kernel within 1e-4), both
             forward kernels' ``lse`` against `_fwd_impl`'s, then
             gemma2's train shape (bf16, 16/8 heads, head_dim 256, 4096
             tokens, causal, softcap 50, with and without the 4096
             window) timed as phase 8 times the forward, beside its bound
             (the rule's five products) and SDPA's backward (fwd + bwd
             minus fwd, no softcap); the f32 routes (forward and
             backward) timed the same way at the train-parity shape and
             at gemma2's train shape, bounds on the f32 peak; then the
             MLA pairs' and (112, 112)'s cases in both dtypes and
             minicpm3-4b's, deepseek-v2-lite's and zamba2-7b's heads at
             the train shape (4096 tokens) in both dtypes, timed the same
             way, then the non-causal cases of
             `tests/test_torch_kernels_gpu.py::CROSS_CASES` (Sq > Skv,
             Sq = 1, Sq = Skv; the forwards' ``lse`` too) and
             seamless-m4t's heads (the encoder's 4,096 frames; 8,192
             decoder positions over them), both dtypes, and the seconds
             the seamless shapes take
             beside the bound at 2 (3 D + 2 Dv) flops a visible pair and
             SDPA's backward where a backend takes the shapes; prints the
             route each dtype takes and the backward libraries'
             ``-Xptxas -v`` lines and SASS counts (by kernel and
             head_dims);
8b. mma_rate — the TF32 rate that the f32 kernels' instruction reaches
             on this card: ``mma.sync`` m16n8k8 from registers, 1 to 16
             independent accumulator chains a warp, 8 warps a block, 4
             blocks an SM (its source built beside the kernels in phase
             1), beside the data sheet's 495 TFLOP/s;
9. serve_parity — a 4-layer, d_model-512 gemma2 in f32 served by
             ``ServeEngine`` on the card and on the CPU from one seeded
             init: equal tokens, the card's prefill logits within 1e-4 of
             the CPU's float64 evaluation, and ``flash_attention``
             launched once a layer a prefill wave; then the same for a
             4-layer, d_model-512 minicpm3 at its own head widths (MLA:
             kv_lora 256, q_lora 768, rope 32, nope 64, v 64; weight
             matrices at std 1/sqrt(d_in), as train_parity's), one line
             each; then ``serve_parity_moe`` the same way for llama4-scout
             cut to 4 layers and deepseek-v2-lite to 2 at d_model 512
             with their own heads and experts (`PARITY_LLAMA4`,
             `PARITY_DEEPSEEK`; fewer, shorter requests), every launch
             through the library of the config's (D, Dv) (deepseek: the
             f32 (192, 128) kernel), the assignments dropped for capacity,
             and for deepseek one train step, its gradients on the card
             within 1e-4 of each leaf's max |g| of float64 (the f32
             backward at (192, 128)); then
             ``serve_parity_ssm`` the same way for mamba2 cut to 4
             layers and zamba2 to 6 (2 groups) at d_model 512
             (`PARITY_MAMBA2`, `PARITY_ZAMBA2`: zamba2's shared block at
             4/4 heads of 112), ``flash_attention`` launched once an
             attention layer a wave (zamba2's 2 ssm_attn layers; none for
             mamba2), and for zamba2 one train step's gradients (the f32
             backward at (112, 112); the shared block's summed over its
             2 layers); then ``serve_parity_encdec``: seamless-m4t cut to
             4 + 4 layers at d_model 512, 8/8 heads of 64, 512 frames
             (`PARITY_ENCDEC`), served through the launcher's waves (stub
             frames from seed 0, the same on card and CPU): equal tokens,
             logits within 1e-4 of float64, ``flash_attention`` launched
             12 times a prefill wave and 4 a decode step (its
             cross-attention); and one train step at 1,024 decoder
             positions over the 512 frames (the f32 backward at
             non-causal Sq > Skv), every leaf, the encoder's included,
             within 1e-4 of its max |g| of float64, forward and backward
             launches the remat's counts;
10. serve  — the serving launcher's defaults on gemma2-9b at full width,
             cut to 12 of its 42 layers (bf16, random weights from seed
             0): 16 requests of 4..63 tokens, 32 new tokens each, waves
             of up to 8, with the ``flash_attention`` count set to 0 just
             before and read just after (it must be 12 x waves);
11. serve_profile — device time by kernel and the device's idle share
             for one wave of that server, under `torch.profiler`;
11a. serve_zoo — the other architectures served in bf16 from
             seed 0, one line each: minicpm3-4b at full width cut to 31
             of its 62 layers (4 requests, 16 new tokens), qwen1.5-110b
             at full width cut to 8 of its 80 layers (4 requests, 16 new
             tokens) and llava-next-34b at
             full width cut to 20 of its 60 layers (one wave of 4 rows:
             2,880 stub patch embeddings and 48 text tokens a row, 16 new
             tokens, through ``ServeEngine.serve(..., extra=)``), then the
             MoEs: deepseek-v2-lite at full width and depth through the
             launcher and llama4-scout at full width cut to 8 of its 48
             layers (4 requests, 16 new tokens), then the SSMs at full
             width and depth through the launcher (``--requests 4
             --max-new 16``): mamba2-780m (48 layers, no attention) and
             zamba2-7b (81 layers, 27 of them with the shared attention
             block at head_dim 112), then seamless-m4t-large-v2 at full
             width and depth (24 + 24 layers, each wave over its 4,096
             stub frames): init s, prefill ms, decode ms, tokens/s, peak
             bytes and share of the card, ``flash_attention`` launches
             against attention layers x waves (seamless: 72 a wave and
             24 a decode step), an
             MoE's assignments dropped for capacity in its prefills,
             finite logits and well-formed outputs;
12. train_parity — a 4-layer, d_model-512 gemma2 in f32 (weight matrices
             at std 1/sqrt(d_in)) trained on the card and on the CPU from
             one init: the card's first-step gradients within 1e-4 of each
             leaf's max |g| of the CPU's float64 evaluation, the
             ``flash_attention`` forward and backward launches a step equal
             to the two-level remat's count (`models.lm.remat_forwards`),
             3 steps' losses within 1e-4, and a checkpointed run killed at
             step 2 and restored giving the uninterrupted losses;
13. train  — the train launcher's `make_trainer` on gemma2-9b at full
             width cut to 20 of its 42 layers (bf16, f32 AdamW state),
             5 steps of `TokenPipeline` at seq 4096, batch 1, with the
             kernel counts set to 0 just before and read just after (they
             must equal the remat's count): loss, step ms, tokens/s and
             grad_norm a step, peak memory and its share of the card; then
             one more step under `torch.profiler` (device time by kernel,
             the device's idle share), and one counted by
             `launch.hlo_stats` (FLOPs, bytes, peak live bytes) beside
             `model_flops`' 6·N·T, their ratio and the share of the
             H100's bf16 peak that the measured median step reaches.

Then the wrappers' host time a call through their custom ops, the
ops' own share of it (``op_dispatch``: host µs a call through the op
against the same kernel call made directly, on small inputs), one
``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Any failure raises and exits non-zero.  It needs one card and imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# H100 SXM dense peaks (data sheet): bf16 tensor cores, f32 CUDA cores,
# and the f32-accurate rate of the tensor cores in 3xTF32 (three TF32
# products a product at 495 TFLOP/s), the f32 kernels' bound
FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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


def host_us(fn, calls: int = 20) -> float:
    """Microseconds of the host's time per ``fn()`` call, with no
    synchronize between the calls (the card runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_ms_by_name(fn, calls: int = 20) -> dict:
    """Device time an event and the events seen, by kernel (or memset)
    name, over ``calls`` calls of ``fn`` under `torch.profiler`; {} if it
    saw none.  (The profiler may miss some of a kernel's events: it saw
    10 of 20 ``flash_fwd_sm90`` launches and every fold launch, so the
    time is taken over the events it saw.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            out[ev.key[:90]] = {"ms": ms / ev.count, "events": ev.count}
    return out


def back_to_back_ms(fn, calls: int = 20) -> float:
    """Milliseconds a call of ``fn`` by CUDA events around ``calls``
    back-to-back calls: the card's time when it, not the host, is the
    slower side."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def fold_times(fn, raw, kernel: str) -> dict:
    """The three times of a fold wrapper ``fn``: ``kernel_ms``, the
    kernel's own device time a launch by name under `torch.profiler` over
    20 calls, with the output's memset apart (or, if the profiler shows no
    device time, CUDA events around 20 back-to-back ``raw()`` launches,
    memset included); ``ms``, the wrapper a call by CUDA events
    (`cuda_ms`, as in earlier runs); ``host_us``, the host's time a
    wrapper call.  ``back_to_back_ms`` (the wrapper by events over 20
    calls in a row) cross-checks the profiler."""
    names = device_ms_by_name(fn)
    kernel_ms = sum(v["ms"] for name, v in names.items() if kernel in name)
    memset_ms = sum(v["ms"] for name, v in names.items()
                    if "memset" in name.lower())
    source = "torch.profiler"
    if not kernel_ms:
        kernel_ms, memset_ms = back_to_back_ms(raw), None
        source = "cuda events, 20 raw launches"
    return {"kernel_ms": kernel_ms, "memset_ms": memset_ms,
            "kernel_ms_source": source, "device_ms_by_name": names,
            "ms": cuda_ms(fn, 20), "host_us": host_us(fn),
            "back_to_back_ms": back_to_back_ms(fn)}


# phase 8b's loop: TF32 mma.sync m16n8k8 with NACC independent chains a
# warp, operands in registers, built beside the kernels (not a kernel of
# the port: it measures the rate that the f32 kernels' instruction reaches)
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>

template <int NACC>
__global__ void __launch_bounds__(256) mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i)
    asm("cvt.rna.tf32.f32 %0, %1;"
        : "=r"(a[i]) : "f"(1.0f + 1e-3f * float(threadIdx.x + i)));
  for (int i = 0; i < 2; ++i)
    asm("cvt.rna.tf32.f32 %0, %1;"
        : "=r"(b[i]) : "f"(1.0f - 1e-3f * float(threadIdx.x + i)));
  float c[NACC][4] = {};
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// launch `blocks` blocks of 8 warps on the current device's default
// stream; out holds blocks * 256 floats; the launch's error code
extern "C" int mma_tf32_loop(int nacc, int blocks, int iters, float* out) {
  switch (nacc) {
    case 1: mma_loop<1><<<blocks, 256>>>(out, iters); break;
    case 2: mma_loop<2><<<blocks, 256>>>(out, iters); break;
    case 4: mma_loop<4><<<blocks, 256>>>(out, iters); break;
    case 8: mma_loop<8><<<blocks, 256>>>(out, iters); break;
    case 16: mma_loop<16><<<blocks, 256>>>(out, iters); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
"""
MMA_RATE_LIB = ROOT / "build" / "mma_rate" / "libmma_rate.so"
MMA_RATE_CHAINS = (1, 2, 4, 8, 16)


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    MMA_RATE_LIB.parent.mkdir(parents=True, exist_ok=True)
    src = MMA_RATE_LIB.with_name("mma_rate.cu")
    src.write_text(MMA_RATE_SRC)
    probe = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(MMA_RATE_LIB),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        _build.build(*_build.SIGNATURES)
    finally:
        log = probe.communicate()[0]
    if probe.returncode:
        raise SystemExit(f"nvcc mma_rate.cu exited {probe.returncode}:\n"
                         f"{log}")
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
           "seconds_by_source": dict(_build.BUILD_SECONDS), "ptxas": ptxas}
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
    from repro_torch.kernels import sig_fold as tfold
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
    # the build's form at full size, in every mode: one block of every
    # edge; the bound counts 13 B a lane read and 8 B a row written
    by_mode = {}
    for mode, (args, kw) in full_lanes.items():
        check(f"build {mode} E={args[0].numel()}", args, **kw)
        e, rows = args[0].numel(), kw["nodes_per_block"]
        out = torch.empty((2, rows), dtype=torch.int64, device=dev)
        row = fold_times(
            lambda: sig_fold(*args, **kw),
            lambda: tfold._launch("sig_fold_flat", args, out, e, e, rows,
                                  int(kw["dedup"])), "fold_flat")
        # what the pre-reduction depends on: lanes a run of one source
        runs = 1 + int((args[2][1:] != args[2][:-1]).sum())
        row.update(plain_ms=cuda_ms(lambda: sig_fold_plain(*args, **kw), 3),
                   lanes_per_run=e / runs,
                   bound_ms=(13 * e + 8 * rows) / HBM_BYTES_PER_S * 1e3,
                   shape={"lanes": e, "rows": rows, "dedup": kw["dedup"],
                          "presorted": True})
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        by_mode[mode] = row
        del out
    timing = {k: by_mode["sorted"][k] for k in (
        "kernel_ms", "ms", "host_us", "plain_ms", "bound_ms", "shape")}
    out = {"phase": "kernels", "kernel": "sig_fold",
           "replaces": "src/repro/kernels/sig_fold.py:113 (_kernel via "
                       "sig_fold :149 and frontier_sig_fold :199)",
           "cases": cases, "mismatches": sum(c["max_abs_err"] != 0
                                             for c in cases),
           "max_abs_err": worst, **timing, "build_modes": by_mode,
           "bound_by": "bytes", "library_ms": None}
    emit(out)
    if worst:
        raise SystemExit("sig_fold disagrees with its plain version")
    return out


def _chunk_lanes(rng, n, chunk_edges, layout, big):
    """One chunk in the fixed-width layout (the JAX package's, and the
    port's before it sized uploads to the chunk): ``n`` lanes of a (src, eLabel, pId)-sorted stream with dense ascending seg,
    padded to ``chunk_edges`` with seg = chunk_edges - 1 and valid False,
    for ``chunk_edges`` rows.  Layouts:
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


def _build_chunk(rng, n, layout):
    """One chunk as the out-of-core build now uploads it: the ``n`` lanes
    of `_chunk_lanes` (u32 values >= 2^31), padded to a multiple of 4
    lanes with seg = u, under an all-True lane mask.  Returns (lanes, u)."""
    import numpy as np
    import torch
    width = -(-n // 4) * 4
    a, b, s, _ = (x.cpu().numpy() for x in _chunk_lanes(rng, n, width,
                                                          layout, True))
    u = int(s[n - 1]) + 1 if n else 0
    s[n:] = u
    dev = torch.device(DEVICE)
    lanes = torch.from_numpy(np.stack([a, b, s])).to(dev)
    return ((lanes[0], lanes[1], lanes[2],
             torch.ones(width, dtype=torch.bool, device=dev)), u)


def _host_steps_us(lanes, u) -> dict:
    """The host's microseconds a call of each step of `chunk_sig_fold`'s
    card path, at one chunk (no synchronize: the card runs behind), and of
    the two calls the path no longer makes (the public stream object and
    the current-device query)."""
    import torch
    from repro_torch.kernels import sig_fold as tfold
    dev = lanes[0].device
    n, index = lanes[0].numel(), dev.index
    out = torch.empty((2, u), dtype=torch.int64, device=dev)
    steps = {
        "checks": lambda: tfold._check_chunk(*lanes, u),
        "contiguity": lambda: all(t.is_contiguous() for t in lanes),
        "empty": lambda: torch.empty((2, u), dtype=torch.int64, device=dev),
        "launch_plan": lambda: tfold.launch_plan(
            n, [t.data_ptr() for t in lanes], tfold._sms(index)),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "c_call": lambda: tfold._launch("chunk_sig_fold", lanes, out, n, u,
                                        1, 1),
        "wrapper": lambda: tfold.chunk_sig_fold(*lanes, True,
                                                num_segments=u),
        "dropped_public_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "dropped_current_device": torch.cuda.current_device,
    }
    return {name: host_us(fn, 200) for name, fn in steps.items()}


# the out-of-core build's mean chunk at full size: 348k real lanes (its
# merge hands the fold 348k lanes a chunk on average)
MEAN_CHUNK = 348_000


def phase_chunk_kernels() -> dict:
    """chunk_sig_fold on the card vs chunk_sig_fold_plain on the card,
    exact, over chunk sizes 2^10..2^22 in the fixed-width layout and as
    the build now uploads them; timed at 2^20 lanes with 2^20 rows (the
    fixed-width shape) and at the build's mean chunk."""
    import numpy as np
    import torch
    from repro_torch.kernels import sig_fold as tfold
    from repro_torch.kernels.sig_fold import (chunk_sig_fold,
                                              chunk_sig_fold_plain)
    rng = np.random.default_rng(1)
    cases, worst, timing = [], 0, {}

    def check(name, lanes, num_segments):
        nonlocal worst
        for dedup, keep0 in ((True, True), (True, False), (False, True),
                             (False, False)):
            kw = dict(num_segments=num_segments, dedup=dedup)
            got = chunk_sig_fold(*lanes, keep0, **kw)
            want = chunk_sig_fold_plain(*lanes, keep0, **kw)
            torch.cuda.synchronize()
            err = _exact(got, want)
            cases.append({"case": f"{name} dedup={dedup} keep0={keep0}",
                          "max_abs_err": err})
            worst = max(worst, err)

    def times(name, lanes, num_segments):
        kw = dict(num_segments=num_segments, dedup=True)
        n = lanes[0].numel()
        out = torch.empty((2, num_segments), dtype=torch.int64,
                          device=lanes[0].device)
        row = fold_times(
            lambda: chunk_sig_fold(*lanes, True, **kw),
            lambda: tfold._launch("chunk_sig_fold", lanes, out, n,
                                  num_segments, 1, 1), "chunk_fold")
        row.update(plain_ms=cuda_ms(
            lambda: chunk_sig_fold_plain(*lanes, True, **kw), 5),
            bound_ms=(13 * n + 8 * num_segments) / HBM_BYTES_PER_S * 1e3,
            shape={"lanes": n, "num_segments": num_segments, "dedup": True,
                   "layout": name})
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        timing[name] = row

    for log2 in (10, 16, 20, 22):
        ce = 1 << log2
        shapes = [("full", ce, layout, layout != "distinct")
                  for layout in ("distinct", "mixed", "hub")]
        shapes += [("partial", ce - ce // 7 - 1, "mixed", True),
                   ("partial", ce // 3, "hub", False),
                   ("all-invalid", 0, "mixed", False)]
        for fill, n, layout, big in shapes:
            lanes = _chunk_lanes(rng, n, ce, layout, big)
            check(f"2^{log2} {fill} {layout} big={big}", lanes, ce)
            if log2 == 20 and fill == "full" and layout == "mixed":
                times("2^20 mixed, num_segments 2^20", lanes, ce)
        for n in (ce - 1, ce // 3 + 1):
            for layout in ("distinct", "mixed", "hub"):
                lanes, u = _build_chunk(rng, n, layout)
                check(f"build upload n={n} {layout} u={u}", lanes, u)
    lanes, u = _build_chunk(rng, MEAN_CHUNK, "mixed")
    check(f"build upload n={MEAN_CHUNK} mixed u={u}", lanes, u)
    times("build mean chunk", lanes, u)
    timing["build mean chunk"]["host_steps_us"] = _host_steps_us(lanes, u)
    old = timing["2^20 mixed, num_segments 2^20"]
    out = {"phase": "kernels", "kernel": "chunk_sig_fold",
           "replaces": "src/repro/kernels/sig_fold.py:221 (_chunk_kernel "
                       "via chunk_sig_fold :279)",
           "cases": len(cases),
           "mismatches": [c for c in cases if c["max_abs_err"]],
           "max_abs_err": worst,
           **{k: old[k] for k in ("kernel_ms", "ms", "host_us", "plain_ms",
                                  "bound_ms", "shape")},
           "shapes": timing, "bound_by": "bytes", "library_ms": None}
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
    out = {"phase": "profile", "mode": "sorted", **_device_top(prof, wall)}
    emit(out)
    if not out["top"]:
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


# the maintenance phase: k and modes of the issue's deployment, and its
# ops in order (name, count): random inserts drawn as the launcher's
# ``add-edges --count`` draws them, existing edges inserted again (the
# fused k-loop's all-clean path), DELETE_NODE on a random node, compact
# (one DELETE_NODE a mode, not two: the second took the same path and
# 5-13 s of the main process, which sets the script's pace here; and the
# 100,000 inserts in one mode: in ``sorted`` they took the device
# propagation that ``multiset``'s take, to the same largest frontier fold
# (747,841 lanes, 127,308 rows), and 19-25 s)
MAINT = dict(k=10, modes=("sorted", "multiset"), seed=0)
_MAINT_TAIL = (("re-add-edges", 1000), ("delete-node", 1), ("compact", 0))
MAINT_OPS = {"sorted": (("add-edges", 1), ("add-edges", 1000)) + _MAINT_TAIL,
             "multiset": (("add-edges", 1), ("add-edges", 1000),
                          ("add-edges", 100_000)) + _MAINT_TAIL}


def _same_partition(a, b) -> bool:
    """Vectorised `same_partition`, on the card: the pid pairs biject."""
    import torch
    a, b = (torch.from_numpy(x).to(DEVICE, torch.int64) for x in (a, b))
    return (torch.unique(a << 32 | b).numel() == torch.unique(a).numel()
            == torch.unique(b).numel())


def _report_dict(rep) -> dict:
    """A report without its seconds and its path flag (which differ by
    design between the device and the host maintainer)."""
    d = rep.as_dict()
    del d["level_seconds"], d["device"]
    return d


def _apply_maint_op(m, op: str, draw):
    """Apply one drawn op to a maintainer; returns its report or None."""
    if op in ("add-edges", "re-add-edges"):
        src, lab, dst = draw
        return m.add_edges(src, lab, dst)
    if op == "delete-node":
        return m.delete_node(draw)
    m.compact()
    return None


def _draw_maint_op(op: str, count: int, g, rng, launcher):
    import argparse
    if op == "add-edges":
        return launcher.draw_edges(argparse.Namespace(edge=[], count=count),
                                   g.num_nodes, rng)
    if op == "re-add-edges":
        idx = rng.integers(0, g.num_edges, count)
        return g.src[idx], g.elabel[idx], g.dst[idx]
    if op == "delete-node":
        return int(rng.integers(0, g.num_nodes))
    return None


def phase_maintenance(g) -> dict:
    """Algorithms 2-4 at full size: one card build with stores, then a
    maintainer with device propagation and one on the numpy host path,
    fed the same ops; after every op their pid histories, next_pid,
    reports (without seconds) and tombstones must agree bit for bit.  At
    the end their stores must equal, and every level must be the
    partition of a fresh card build of the final graph.  Every frontier
    fold of the device maintainer is recorded (lanes, rows, dedup) for
    the frontier kernel cases; ``sig_fold.launches`` is set to 0 just
    before each device op and read just after (a §4.2 rebuild adds its
    build's k launches)."""
    import numpy as np
    import torch
    from repro_torch.core import BisimMaintainer, build_bisim
    from repro_torch.core import device_maint
    from repro_torch.kernels.sig_fold import sig_fold
    from repro_torch.launch import bisim as launcher
    k = MAINT["k"]
    folds, runs, all_ops, ok = [], [], [], True
    record = device_maint._fold

    def fold(batch, tgt, *, dedup):
        folds.append((batch.e, batch.p0.numel(), dedup))
        return record(batch, tgt, dedup=dedup)

    for mode in MAINT["modes"]:
        t0 = time.perf_counter()
        res = build_bisim(g, k, mode=mode, early_stop=False,
                          with_store=True, device=DEVICE)
        dev_m = BisimMaintainer(g, k, mode=mode, result=res, device=DEVICE)
        host_m = BisimMaintainer(g, k, mode=mode, result=res, device=DEVICE,
                                 device_propagation=False)
        del res
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(MAINT["seed"])
        ops = []
        for op, count in MAINT_OPS[mode]:
            draw = _draw_maint_op(op, count, dev_m.graph, rng, launcher)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n_folds = len(folds)
            device_maint._fold = fold
            sig_fold.launches = 0
            try:
                t0 = time.perf_counter()
                rep = _apply_maint_op(dev_m, op, draw)
                torch.cuda.synchronize()
                dev_s = time.perf_counter() - t0
            finally:
                device_maint._fold = record
            launches = sig_fold.launches
            peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            host_rep = _apply_maint_op(host_m, op, draw)
            host_s = time.perf_counter() - t0
            shapes = folds[n_folds:]
            rebuilt = bool(rep is not None and rep.rebuilt)
            frontier_launches = sum(e > 0 for e, _, _ in shapes)
            equal = (
                dev_m.k == host_m.k
                and all(np.array_equal(a, b)
                        for a, b in zip(dev_m.pids, host_m.pids))
                and list(dev_m.next_pid) == list(host_m.next_pid)
                and np.array_equal(dev_m._tombstone, host_m._tombstone)
                and (rep is None) == (host_rep is None)
                and (rep is None or (_report_dict(rep)
                                     == _report_dict(host_rep)
                                     and rep.device and not host_rep.device)))
            row = {"phase": "maintenance", "mode": mode, "op": op,
                   "count": count,
                   "frontier": rep.nodes_checked if rep else None,
                   "changed": rep.nodes_changed if rep else None,
                   "rebuilt": rebuilt, "device_s": dev_s, "host_s": host_s,
                   "level_s_device": rep.level_seconds if rep else None,
                   "sig_fold_launches": launches,
                   "frontier_sig_fold_launches": frontier_launches,
                   "fold_lanes_max": max((e for e, _, _ in shapes),
                                         default=0),
                   "store_sizes": [len(d) for d in dev_m.backend._dstores],
                   "device_store_bytes": dev_m.backend.device_store_bytes,
                   "peak_bytes": peak, "num_edges": dev_m.graph.num_edges,
                   "equal": bool(equal)}
            emit(row)
            ops.append(row)
            all_ops.append(row)
            ok &= equal and launches == frontier_launches + k * rebuilt
        t0 = time.perf_counter()
        stores_equal = all(
            np.array_equal(a.keys, b.keys) and np.array_equal(a.pids, b.pids)
            for a, b in zip(dev_m.stores, host_m.stores))
        fresh = build_bisim(dev_m.graph, k, mode=mode, early_stop=False,
                            device=DEVICE)
        rebuild_equal = all(_same_partition(dev_m.pids[j], fresh.pids[j])
                            for j in range(k + 1))
        runs.append({"mode": mode, "setup_s": setup_s,
                     "check_s": time.perf_counter() - t0,
                     "stores_equal": stores_equal,
                     "fresh_build_same_partition": rebuild_equal,
                     "ops_equal": all(r["equal"] for r in ops),
                     "device_s": sum(r["device_s"] for r in ops),
                     "host_s": sum(r["host_s"] for r in ops)})
        ok &= stores_equal and rebuild_equal
        del dev_m, host_m, fresh
        torch.cuda.empty_cache()
    # the path must have run: some op propagated through a level on the
    # device, its folds through the kernel, without the §4.2 rebuild
    propagated = [(r["mode"], r["op"], r["count"]) for r in all_ops
                  if not r["rebuilt"] and r["frontier_sig_fold_launches"]]
    lanes = sorted(e for e, _, _ in folds if e > 0)
    out = {"phase": "maintenance", "k": k, "modes": list(MAINT["modes"]),
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           "runs": runs, "propagated_on_device": propagated,
           "frontier_sig_fold_launches": sum(
               r["frontier_sig_fold_launches"] for r in all_ops),
           "frontier_folds": len(lanes),
           "fold_lanes": {"max": lanes[-1] if lanes else 0,
                          "median": lanes[len(lanes) // 2] if lanes else 0},
           "ok": bool(ok and propagated)}
    emit(out)
    if not propagated:
        raise SystemExit("maintenance: no op propagated on the device "
                         "(every op rebuilt or folded nothing)")
    if not ok:
        raise SystemExit("maintenance: device and host propagation differ, "
                         "or the maintained partition is not the build's")
    return out, folds


def phase_frontier_kernels(folds) -> dict:
    """``frontier_sig_fold`` (kernel row 2) at the shapes the maintenance
    phase folded: its largest and its median batch (lanes, rows), as
    synthetic lanes of that shape (ascending seg over the rows, labels in
    [0, 3), pids below the graph's node count, sorted by triple as the
    device path hands them over), both dedup settings, presorted; each
    held to ``sig_fold_plain`` (exact) and timed as the kernels phase
    times the build's fold, beside its byte bound (13 B a lane read, 8 B
    a row written, at the data sheet's rate)."""
    import numpy as np
    import torch
    from repro_torch.kernels import sig_fold as tfold
    from repro_torch.kernels.sig_fold import frontier_sig_fold, sig_fold_plain
    dev = torch.device(DEVICE)
    by_lanes = sorted((e, ns) for e, ns, _ in folds if e > 0)
    picks = {"largest": by_lanes[-1], "median": by_lanes[len(by_lanes) // 2]}
    rng = np.random.default_rng(2)
    cases, worst = {}, 0
    for name, (e, ns) in picks.items():
        seg = np.sort(rng.integers(0, ns, e))
        a = rng.integers(0, 3, e)
        b = rng.integers(0, FULL["nodes"], e)
        order = np.lexsort((b, a, seg))
        cols = tuple(torch.from_numpy(x[order].astype(np.int32)).to(dev)
                     for x in (a, b, seg)) + (
            torch.ones(e, dtype=torch.bool, device=dev),)
        for dedup in (True, False):
            kw = dict(nodes_per_block=ns, edges_per_block=e, dedup=dedup,
                      presorted=True)
            got = frontier_sig_fold(*cols, num_sigs=ns, dedup=dedup)
            want = sig_fold_plain(*cols, **kw)
            torch.cuda.synchronize()
            err = _exact(got, want)
            worst = max(worst, err)
            out = torch.empty((2, ns), dtype=torch.int64, device=dev)
            row = fold_times(
                lambda: frontier_sig_fold(*cols, num_sigs=ns, dedup=dedup),
                lambda: tfold._launch("sig_fold_flat", cols, out, e, e, ns,
                                      int(dedup)), "fold_flat")
            row.update(max_abs_err=err,
                       plain_ms=cuda_ms(lambda: sig_fold_plain(*cols, **kw),
                                        3),
                       bound_ms=(13 * e + 8 * ns) / HBM_BYTES_PER_S * 1e3,
                       shape={"lanes": e, "rows": ns, "dedup": dedup,
                              "presorted": True})
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            cases[f"{name} dedup={dedup}"] = row
            del out
    out = {"phase": "frontier_kernels", "kernel": "frontier_sig_fold",
           "replaces": "src/repro/kernels/sig_fold.py:199 (frontier_sig_fold"
                       " -> _kernel)", "cases": cases, "max_abs_err": worst,
           "bound_by": "bytes", "library_ms": None}
    emit(out)
    if worst:
        raise SystemExit("frontier_sig_fold disagrees with its plain version")
    return out


# the out-of-core maintenance phases: the parity graph at k=10 in two
# modes with stores that spill, then the full graph at k=4 (its partition
# stops changing at level 4, so k=4 keeps every level that differs, and
# each out-of-core level of the backend's build takes 22-28 s there); the
# ops (name, count) in order, drawn as the launcher draws them
OOC_PARITY = dict(k=10, modes=("sorted", "multiset"), spill_threshold=1 << 14,
                  seed=0, snapshot_after=2)
OOC_PARITY_OPS = (("add-edges", 1), ("add-edges", 1000),
                  ("delete-edges", 100), ("add-nodes", 10),
                  ("delete-node", 1), ("compact", 0), ("change-k", 6),
                  ("change-k", 10))
OOC_MAINT = dict(k=4, mode="sorted", chunk_edges=1 << 20, io_threads=1,
                 seed=0)
# (no single insert: it takes the 1,000-insert op's path and ~20 s, the
# parity phase runs one, and the whole script must stay near 15 minutes;
# nor a 1,000-insert op ahead of the 100,000: the two after the snapshot
# and after the recovery take that path, and each op costs 20-34 s; nor
# a DELETE_NODE: `ooc_maintenance_parity` drives that path, and here it
# took 14-20 s of the main process, which paces stage 2 on a slow host)
OOC_MAINT_OPS = (("add-edges", 100_000), ("snapshot", 0), ("add-edges", 1000))
OOC_WORKDIR = ROOT / "build" / "ooc-maint-smoke"  # removed at exit
OOC_PARITY_WORKDIR = ROOT / "build" / "ooc-parity-smoke"  # the same


def _draw_ooc_op(op: str, count: int, g, num_nodes: int, rng, launcher):
    """The arguments of one op: random inserts as ``add-edges --count``
    draws them, existing edges of ``g`` (distinct) to delete, labels of
    new nodes, a random node to delete, the new k."""
    import argparse
    if op == "add-edges":
        return launcher.draw_edges(argparse.Namespace(edge=[], count=count),
                                   num_nodes, rng)
    if op == "delete-edges":
        idx = rng.choice(g.num_edges, count, replace=False)
        return g.src[idx], g.elabel[idx], g.dst[idx]
    if op == "add-nodes":
        return rng.integers(0, 4, count)
    if op == "delete-node":
        return int(rng.integers(0, num_nodes))
    return count


def _apply_ooc_op(m, op: str, draw):
    """Apply one drawn op; its report, else None."""
    if op == "add-edges":
        return m.add_edges(*draw)
    if op == "delete-edges":
        return m.delete_edges(*draw)
    if op == "add-nodes":
        m.add_nodes(draw)
    elif op == "delete-node":
        return m.delete_node(draw)
    elif op == "compact":
        m.compact()
    elif op == "change-k":
        m.change_k(draw)
    elif op == "snapshot":
        m.snapshot()
    return None


def _ooc_state(m) -> dict:
    """What must be equal between out-of-core maintainers: pid files as
    they lie on disk, next_pid, tombstones, IOStats, and each store's run
    state after a flush (every maintainer compared is flushed alike)."""
    import numpy as np
    for s in m.backend.stores:
        s.flush()
    return {"pids": [np.load(p) for p in m.backend.pid_paths],
            "next_pid": list(m.next_pid), "tombstone": m._tombstone.copy(),
            "io": m.backend.io.to_dict(),
            "stores": [s.state() for s in m.backend.stores]}


def _same_ooc_state(a: dict, b: dict) -> bool:
    import numpy as np
    return (len(a["pids"]) == len(b["pids"])
            and all(np.array_equal(x, y)
                    for x, y in zip(a["pids"], b["pids"]))
            and a["next_pid"] == b["next_pid"]
            and np.array_equal(a["tombstone"], b["tombstone"])
            and a["io"] == b["io"] and a["stores"] == b["stores"])


def phase_ooc_maintenance_parity() -> dict:
    """`OocBackend` maintenance on the card with device propagation, on
    the card with host propagation and on the CPU (plain folds), fed the
    same ops on the parity graph: after every op the three must be equal
    bit for bit (pid files, next_pid, tombstones, IOStats, stores).  Then
    a WAL'd run on the card: snapshot after op 2, an observer pass counts
    the fault points of the rest, a second run is killed at a point
    drawn from ``default_rng(0)``, restored and finished; its pid history
    must equal the never-killed run's."""
    import numpy as np
    from repro_torch.core import BisimMaintainer, faults
    from repro_torch.exmem import OocBackend
    from repro_torch.graph import generators as gen
    from repro_torch.kernels.sig_fold import chunk_sig_fold, sig_fold
    from repro_torch.launch import bisim as launcher
    t0 = time.perf_counter()
    g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3, seed=0)
    k = OOC_PARITY["k"]
    bkw = dict(chunk_edges=OOCORE["parity_chunk_edges"],
               spill_threshold=OOC_PARITY["spill_threshold"])

    def maintainer(name, mode, device, prop, **kw):
        be = OocBackend(g, workdir=str(OOC_PARITY_WORKDIR / name),
                        device=device, **bkw, **kw)
        return BisimMaintainer(be, k, mode=mode, device_propagation=prop,
                               wal=kw.get("wal", False))

    def draws():
        rng = np.random.default_rng(OOC_PARITY["seed"])
        n = g.num_nodes
        out = []
        for op, count in OOC_PARITY_OPS:
            out.append(_draw_ooc_op(op, count, g, n, rng, launcher))
            n += count if op == "add-nodes" else 0
        return out

    rows, ok, clean = [], True, None
    for mode in OOC_PARITY["modes"]:
        ms = {name: maintainer(f"{mode}-{name}", mode, dev, prop)
              for name, dev, prop in (("card", DEVICE, True),
                                      ("card_host", DEVICE, False),
                                      ("cpu", "cpu", True))}
        for (op, count), draw in zip(OOC_PARITY_OPS, draws()):
            launches = {}
            for name, m in ms.items():
                sig_fold.launches = chunk_sig_fold.launches = 0
                rep = _apply_ooc_op(m, op, draw)
                launches[name] = (sig_fold.launches, chunk_sig_fold.launches)
            states = {name: _ooc_state(m) for name, m in ms.items()}
            equal = (_same_ooc_state(states["card"], states["cpu"])
                     and _same_ooc_state(states["card_host"],
                                         states["cpu"]))
            row = {"phase": "ooc_maintenance_parity", "mode": mode,
                   "op": op, "count": count,
                   "frontier": rep.nodes_checked if rep else None,
                   "rebuilt": bool(rep is not None and rep.rebuilt),
                   "frontier_sig_fold_launches": launches["card"][0],
                   "chunk_sig_fold_launches": launches["card"][1],
                   "cpu_launches": launches["cpu"],
                   "io": states["card"]["io"], "equal": bool(equal)}
            emit(row)
            rows.append(row)
            ok &= equal and launches["cpu"] == (0, 0)
        if mode == OOC_PARITY["modes"][0]:
            clean = states["card"]
        for m in ms.values():
            m.backend.close()
    # the WAL'd run: count the fault points past the snapshot, then kill
    mode, snap = OOC_PARITY["modes"][0], OOC_PARITY["snapshot_after"]
    ops = list(zip(OOC_PARITY_OPS, draws()))
    kw = dict(wal=True, io_threads=0)
    m = maintainer("wal-observer", mode, DEVICE, True, **kw)
    lsn_after = []
    for (op, _), draw in ops[:snap]:
        _apply_ooc_op(m, op, draw)
        lsn_after.append(m.backend._wal.last_lsn)
    m.snapshot()
    with faults.install_fault_plan(faults.FaultPlan()) as seen:
        for (op, _), draw in ops[snap:]:
            _apply_ooc_op(m, op, draw)
            lsn_after.append(m.backend._wal.last_lsn)
    # the WAL'd run's IOStats and stores carry its snapshot: compare pids
    observer = _ooc_state(m)
    observer_equal = (len(observer["pids"]) == len(clean["pids"])
                      and all(np.array_equal(a, b) for a, b in
                              zip(observer["pids"], clean["pids"]))
                      and observer["next_pid"] == clean["next_pid"])
    m.backend.close()
    total = seen.points_seen
    kill_at = int(np.random.default_rng(0).integers(1, total + 1))
    m = maintainer("wal-killed", mode, DEVICE, True, **kw)
    for (op, _), draw in ops[:snap]:
        _apply_ooc_op(m, op, draw)
    m.snapshot()
    crashed = False
    with faults.install_fault_plan(faults.FaultPlan(crash_at=kill_at)):
        try:
            for (op, _), draw in ops[snap:]:
                _apply_ooc_op(m, op, draw)
        except faults.InjectedCrash:
            crashed = True
    m.backend.aio.close()  # the dead process: no close(), no snapshot
    be, state = OocBackend.restore(str(OOC_PARITY_WORKDIR / "wal-killed"),
                                   io_threads=0, device=DEVICE)
    m = BisimMaintainer.restore(be, state)
    done = 0
    while done < len(ops) and lsn_after[done] <= be._wal.committed_lsn:
        done += 1
    for (op, _), draw in ops[done:]:
        _apply_ooc_op(m, op, draw)
    recovered = _ooc_state(m)
    recovered_equal = (crashed and m.k == k and all(
        np.array_equal(a, b) for a, b in zip(recovered["pids"],
                                              clean["pids"]))
        and len(recovered["pids"]) == len(clean["pids"])
        and recovered["next_pid"] == clean["next_pid"])
    be.close()
    out = {"phase": "ooc_maintenance_parity",
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           "k": k, "modes": list(OOC_PARITY["modes"]), **bkw,
           "ops_equal": all(r["equal"] for r in rows),
           "frontier_sig_fold_launches": sum(
               r["frontier_sig_fold_launches"] for r in rows),
           "chunk_sig_fold_launches": sum(
               r["chunk_sig_fold_launches"] for r in rows),
           "wal": {"fault_points": total, "killed_at": kill_at,
                   "crashed": crashed, "ops_replayed_or_kept": done,
                   "observer_equal_clean": bool(observer_equal),
                   "recovered_equal_clean": bool(recovered_equal)},
           "seconds": time.perf_counter() - t0}
    emit(out)
    shutil.rmtree(OOC_PARITY_WORKDIR, ignore_errors=True)
    if not (ok and observer_equal and recovered_equal):
        raise SystemExit("ooc_maintenance_parity: card and CPU differ, or "
                         "the recovered run is not the clean run")
    return out


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_ooc_maintenance(g) -> dict:
    """`OocBackend` maintenance of the full graph at k=4, ``sorted``, with
    the write-ahead log: one maintainer propagating on the card and an
    in-memory maintainer on the card beside it take the same ops; after
    each, every level's partition must equal the in-memory one.  After
    the snapshot and 1,000 more inserts the out-of-core maintainer is
    dropped without a close (a crash), restored with device propagation,
    and must give back the pre-crash pid files bit for bit; one more
    1,000 inserts go to both, and every level must then be the partition
    of a fresh card build.  The kernels' counts are set to 0 just before
    each op and read just after."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import BisimMaintainer, build_bisim
    from repro_torch.exmem import OocBackend
    from repro_torch.kernels.sig_fold import chunk_sig_fold, sig_fold
    from repro_torch.launch import bisim as launcher
    k, mode = OOC_MAINT["k"], OOC_MAINT["mode"]
    wd = OOC_WORKDIR / "full"

    def same_levels(m, mem) -> bool:
        return len(m.backend.pid_paths) == k + 1 and all(
            _same_partition(np.load(p), mem.pids[j])
            for j, p in enumerate(m.backend.pid_paths))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = OocBackend(g, chunk_edges=OOC_MAINT["chunk_edges"],
                         io_threads=OOC_MAINT["io_threads"], wal=True,
                         workdir=str(wd), device=DEVICE)
    spill_s = time.perf_counter() - t0
    sig_fold.launches = chunk_sig_fold.launches = 0
    t0 = time.perf_counter()
    with obs.tracing() as tracer:
        m = BisimMaintainer(backend, k, mode=mode, wal=True)
    torch.cuda.synchronize()
    build = {"phase": "ooc_maintenance", "op": "build",
             "spill_tables_s": spill_s, "wall_s": time.perf_counter() - t0,
             "chunk_sig_fold_launches": chunk_sig_fold.launches,
             "chunks_folded": len(tracer.find("build.fold")),
             "io": backend.io.to_dict(),
             "store_sizes": [len(s) for s in backend.stores],
             "spilled_runs": [s.num_spilled_runs for s in backend.stores],
             "peak_bytes": torch.cuda.max_memory_allocated()}
    del tracer
    t0 = time.perf_counter()
    mem = BisimMaintainer(g, k, mode=mode, device=DEVICE)
    torch.cuda.synchronize()
    build["inmemory_wall_s"] = time.perf_counter() - t0
    build["same_partition"] = same_levels(m, mem)
    emit(build)
    ok = (build["chunk_sig_fold_launches"] == build["chunks_folded"] > 0
          and build["same_partition"])
    rng = np.random.default_rng(OOC_MAINT["seed"])
    rows, snap = [], None
    for op, count in OOC_MAINT_OPS + (("crash", 0), ("add-edges", 1000)):
        if op == "crash":
            before = _ooc_state(m)
            backend.aio.close()  # the crash: no close(), no snapshot
            del m, backend
            t0 = time.perf_counter()
            backend, state = OocBackend.restore(
                str(wd), io_threads=OOC_MAINT["io_threads"], device=DEVICE)
            replayed = []
            records = backend.wal_replay_records

            def counted(after_lsn=0):
                for rec in records(after_lsn=after_lsn):
                    replayed.append(rec[0])
                    yield rec
            backend.wal_replay_records = counted
            m = BisimMaintainer.restore(backend, state)
            del backend.wal_replay_records
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            io = backend.io.to_dict()
            after = _ooc_state(m)
            row = {"phase": "ooc_maintenance", "op": "recover",
                   "seconds": seconds, "verified_bytes": io["scan_bytes"],
                   "io": io, "wal_records_replayed": len(replayed),
                   "wal_lsn": state["wal_lsn"],
                   "pid_files_equal": (
                       len(after["pids"]) == len(before["pids"])
                       and all(np.array_equal(a, b) for a, b in
                               zip(after["pids"], before["pids"]))),
                   "next_pid_equal": after["next_pid"] == before["next_pid"],
                   "tombstones_equal": bool(np.array_equal(
                       after["tombstone"], before["tombstone"]))}
            emit(row)
            ok &= (row["pid_files_equal"] and row["next_pid_equal"]
                   and row["tombstones_equal"] and len(replayed) > 0)
            rows.append(row)
            continue
        draw = _draw_ooc_op(op, count, g, backend.num_nodes, rng, launcher)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        io0 = backend.io.to_dict()
        sig_fold.launches = chunk_sig_fold.launches = 0
        t0 = time.perf_counter()
        rep = _apply_ooc_op(m, op, draw)
        torch.cuda.synchronize()
        ooc_s = time.perf_counter() - t0
        launches = (sig_fold.launches, chunk_sig_fold.launches)
        peak = torch.cuda.max_memory_allocated()
        io1 = backend.io.to_dict()
        row = {"phase": "ooc_maintenance", "op": op, "count": count,
               "oocore_s": ooc_s,
               "io_delta": {key: io1[key] - io0[key] for key in io1},
               "peak_bytes": peak}
        if op == "snapshot":
            row["written_bytes"] = _dir_bytes(wd / "snapshot")
            row["wal_lsn"] = backend._wal.committed_lsn
        else:
            t0 = time.perf_counter()
            mem_rep = _apply_ooc_op(mem, op, draw)
            torch.cuda.synchronize()
            row.update(
                inmemory_s=time.perf_counter() - t0,
                frontier=rep.nodes_checked, changed=rep.nodes_changed,
                rebuilt=rep.rebuilt,
                frontier_sig_fold_launches=launches[0],
                chunk_sig_fold_launches=launches[1],
                spilled_runs=[s.num_spilled_runs for s in backend.stores],
                store_sizes=[len(s) for s in backend.stores],
                reports_equal=all(
                    getattr(rep, f) == getattr(mem_rep, f)
                    for f in ("nodes_checked", "nodes_changed", "rebuilt")),
                same_partition=same_levels(m, mem))
            ok &= row["same_partition"] and row["reports_equal"]
        emit(row)
        rows.append(row)
    t0 = time.perf_counter()
    final = m.graph
    graph_equal = all(np.array_equal(getattr(final, c), getattr(mem.graph, c))
                      for c in ("node_labels", "src", "dst", "elabel"))
    fresh = build_bisim(final, k, mode=mode, early_stop=False, device=DEVICE)
    fresh_equal = all(_same_partition(np.load(p), fresh.pids[j])
                      for j, p in enumerate(m.backend.pid_paths))
    check_s = time.perf_counter() - t0
    m.backend.close()
    shutil.rmtree(OOC_WORKDIR, ignore_errors=True)
    propagated = [(r["op"], r["count"]) for r in rows
                  if r.get("frontier_sig_fold_launches")
                  and not r.get("rebuilt")]
    out = {"phase": "ooc_maintenance", "k": k, "mode": mode,
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           **{key: OOC_MAINT[key] for key in ("chunk_edges", "io_threads")},
           "build_chunk_sig_fold_launches": build["chunk_sig_fold_launches"],
           "chunk_sig_fold_launches": build["chunk_sig_fold_launches"] + sum(
               r.get("chunk_sig_fold_launches", 0) for r in rows),
           "frontier_sig_fold_launches": sum(
               r.get("frontier_sig_fold_launches", 0) for r in rows),
           "propagated_on_device": propagated,
           "graph_equal_inmemory": graph_equal,
           "fresh_build_same_partition": fresh_equal, "check_s": check_s,
           "oocore_s": sum(r.get("oocore_s", 0) for r in rows),
           "inmemory_s": sum(r.get("inmemory_s", 0) for r in rows),
           "ok": bool(ok and graph_equal and fresh_equal and propagated)}
    emit(out)
    if not propagated:
        raise SystemExit("ooc_maintenance: no op propagated through "
                         "frontier_sig_fold on the card without a rebuild")
    if not out["ok"]:
        raise SystemExit("ooc_maintenance: the out-of-core maintainer "
                         "differs from the in-memory one or the fresh "
                         "build, or recovery is not bit-identical")
    return out


# ------------------------------------------------------------- quotient
# the quotient engine: parity graph at k=10 (levels 1, 5, 10), then the
# full graph at k=4 (its partition stops changing at level 4)
QPARITY = dict(k=10, levels=(1, 5, 10), seed=0, batch=64, points=8,
               ops=(("add-edges", 1000), ("delete-node", 1), ("compact", 0),
                    ("change-k", 6)))
# (one patch: a second of 100,000 inserts took the same path and 45-52 s
# of the worker, which paces stage 2 beside the main process)
QUOTIENT = dict(k=4, mode="sorted", batch=64, budget_rows=1 << 20,
                path_queries=32, point_lookups=64, brute_sample=16,
                seed=0, ops=(("add-edges", 1000),))
QUOTIENT_WORKDIR = ROOT / "build" / "quotient-smoke"  # removed at exit
# the streaming service: the launcher's serve-updates on the parity graph,
# cut from its default 200 ops to 120 (the card's drill, three runs of the
# stream, took 645-762 s and paced the maintenance stage; killed at op 72
# it still recovers from a snapshot and replays the WAL's tail)
STREAM = dict(k=10, mode="sorted", kill_at=72, ops=120, batch_ops=32,
              drill_snapshot_every=2)
STREAM_WORKDIR = ROOT / "build" / "stream-smoke"  # removed at exit
# the host-bound runs of the quotient and stream phases go to worker
# processes of this script (logs and results here, removed at exit)
WORKER_DIR = ROOT / "build" / "smoke-workers"


def _walk_labels(g, off, rng, length: int, tries: int = 120):
    """Edge labels of a random walk of ``length`` hops, or None."""
    for _ in range(tries):
        cur, labs = int(rng.integers(g.num_nodes)), []
        for _ in range(length):
            lo, hi = int(off[cur]), int(off[cur + 1])
            if hi == lo:
                labs = None
                break
            e = int(rng.integers(lo, hi))
            labs.append(int(g.elabel[e]))
            cur = int(g.dst[e])
        if labs is not None:
            return tuple(labs)
    return None


def _parity_queries(g, rng, levels, points: int) -> list:
    """`tests/test_quotient.py`'s suite, cut to three path lengths a
    level: at each level realizable paths of lengths 1, half the level
    and the level (random walks) as a `LabelPath` and as `ReachTemplate`s
    with a source or a target label, one unrealizable path, then point
    lookups at the first, last and random nodes."""
    from repro_torch.quotient import LabelPath, PointLookup, ReachTemplate
    off, qs = g.out_offsets(), []
    for level in levels:
        for length in sorted({1, max(1, level // 2), level}):
            p = _walk_labels(g, off, rng, length)
            if p is not None:
                qs += [LabelPath(p, level=level),
                       ReachTemplate(p, src_label=0, level=level),
                       ReachTemplate(p, tgt_label=1, level=level)]
        qs.append(LabelPath((9,) * level, level=level))
    nodes = [0, g.num_nodes - 1] + [int(x) for x in
                                    rng.integers(0, g.num_nodes, points)]
    qs += [PointLookup(n, level) for n in nodes for level in levels]
    return qs


def _same_answers(a, b) -> bool:
    import numpy as np
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def _brute_hist(m):
    return [m.backend.pid_column(j) for j in range(m.k + 1)]


def _launches_by_row(rows) -> dict:
    """The ``sig_fold`` wrapper's launches of a quotient phase's rows by
    kernel row: the builds' and those of any op that took the §4.2
    rebuild (row 1, `sig_fold`), the other ops' (row 2, their
    `frontier_sig_fold` calls)."""
    build = [r["sig_fold_launches"] for r in rows
             if r.get("op") in ("build", "materialize") or r.get("rebuilt")]
    ops = [r["sig_fold_launches"] for r in rows
           if "sig_fold_launches" in r and r.get("op") not in (
               "build", "materialize") and not r.get("rebuilt")]
    return {"build_sig_fold_launches": sum(build),
            "frontier_sig_fold_launches": sum(ops)}


def _service_op(svc, op: str, count: int, rng, launcher):
    """One update through the `QuotientService`, drawn as the launcher
    draws it; returns the maintainer's report or None."""
    import argparse
    m = svc.m
    if op == "add-edges":
        src, lab, dst = launcher.draw_edges(
            argparse.Namespace(edge=[], count=count), m.backend.num_nodes,
            rng)
        return svc.add_edges(src, lab, dst)
    if op == "delete-node":
        return svc.delete_node(int(rng.integers(0, m.backend.num_nodes)))
    if op == "compact":
        svc.compact()
        return None
    svc.change_k(count)
    return None


def phase_quotient_parity() -> dict:
    """The quotient engine on the parity graph at k=10 in every mode: the
    maintainer builds on the card (`sig_fold`), `QuotientService`
    materializes, and its card engine, a CPU engine over the same index
    and `eval_ref` must agree exactly on a seeded query suite at levels 1,
    5 and 10, together with `eval_brute` on the original graph.  Then
    (``sorted``) 1,000 inserts, a DELETE_NODE, a compact and a Change-k
    10 -> 6 go through the service (its frontier folds through
    `frontier_sig_fold`): after each the same agreement, and the patched
    index answers as a freshly materialized one.  ``sig_fold.launches``
    is set to 0 just before each build and each op and read just after:
    an op's launches are its frontier folds, and count with the builds
    if it took the §4.2 rebuild (whose build folds the same way)."""
    import numpy as np
    import torch
    from repro_torch.core import BisimMaintainer
    from repro_torch.graph import generators as gen
    from repro_torch.kernels.sig_fold import sig_fold
    from repro_torch.launch import bisim as launcher
    from repro_torch.quotient import (QuotientEngine, QuotientService,
                                      eval_brute, eval_ref,
                                      materialize_quotient)
    t_phase = time.perf_counter()
    g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3, seed=0)
    k, rows, ok = QPARITY["k"], [], True

    def check(svc, queries, tag) -> dict:
        m = svc.m
        t0 = time.perf_counter()
        card = svc.query(queries)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu = QuotientEngine(svc.index, max_batch=QPARITY["batch"],
                             device="cpu").query(queries)
        hist = _brute_hist(m)
        ref = [eval_ref(svc.index, q) for q in queries]
        brute = [eval_brute(m.graph, q, hist) for q in queries]
        return {"tag": tag, "queries": len(queries), "card_s": card_s,
                "card_eq_cpu": all(map(_same_answers, card, cpu)),
                "card_eq_ref": all(map(_same_answers, card, ref)),
                "card_eq_brute": all(map(_same_answers, card, brute)),
                "answer_nodes": int(sum(a.shape[0] for a in card
                                        if isinstance(a, np.ndarray)))}

    for mode in MODES:
        rng = np.random.default_rng(QPARITY["seed"])
        sig_fold.launches = 0
        t0 = time.perf_counter()
        m = BisimMaintainer(g, k, mode=mode, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = sig_fold.launches
        t0 = time.perf_counter()
        svc = QuotientService(m, str(QUOTIENT_WORKDIR / "parity" / mode),
                              max_batch=QPARITY["batch"])
        mat_s = time.perf_counter() - t0
        queries = _parity_queries(g, rng, QPARITY["levels"],
                                  QPARITY["points"])
        row = {"phase": "quotient_parity", "mode": mode, "op": "build",
               "build_s": build_s, "sig_fold_launches": build_launches,
               "materialize_s": mat_s, "counts": svc.index.counts,
               "edges": [svc.index.levels[j].num_edges
                         for j in range(1, k + 1)],
               **check(svc, queries, "build")}
        row["equal"] = (row["card_eq_cpu"] and row["card_eq_ref"]
                        and row["card_eq_brute"] and build_launches > 0)
        emit(row)
        rows.append(row)
        if mode == "sorted":
            for op, count in QPARITY["ops"]:
                sig_fold.launches = 0
                t0 = time.perf_counter()
                rep = _service_op(svc, op, count, rng, launcher)
                torch.cuda.synchronize()
                patch_s = time.perf_counter() - t0
                launches = sig_fold.launches
                rebuilt = bool(rep is not None and rep.rebuilt)
                queries = _parity_queries(m.graph, rng, tuple(
                    lv for lv in QPARITY["levels"] if lv <= m.k),
                    QPARITY["points"])
                op_row = {"phase": "quotient_parity", "mode": mode,
                          "op": op, "count": count, "patch_s": patch_s,
                          "epoch": svc.epoch, "engine_epoch":
                          svc.engine.epoch, "patches": svc.patches,
                          "rematerializations": svc.rematerializations,
                          "rebuilt": rebuilt,
                          "sig_fold_launches": launches,
                          **check(svc, queries, op)}
                fresh = True
                if op in ("add-edges", "delete-node"):
                    oracle = materialize_quotient(
                        m.graph, m.backend,
                        str(QUOTIENT_WORKDIR / "parity" / f"oracle-{op}"),
                        counts=[int(x) for x in m.next_pid], mode=m.mode)
                    fresh = all(_same_answers(eval_ref(svc.index, q),
                                              eval_ref(oracle, q))
                                for q in queries)
                op_row["patched_eq_rematerialized"] = fresh
                op_row["equal"] = (op_row["card_eq_cpu"]
                                   and op_row["card_eq_ref"]
                                   and op_row["card_eq_brute"] and fresh
                                   and svc.engine.epoch == svc.epoch)
                emit(op_row)
                rows.append(op_row)
            ok &= _launches_by_row(rows)["frontier_sig_fold_launches"] > 0
        ok &= all(r["equal"] for r in rows)
        del svc, m
        torch.cuda.empty_cache()
    shutil.rmtree(QUOTIENT_WORKDIR / "parity", ignore_errors=True)
    out = {"phase": "quotient_parity",
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           "k": k, "levels": list(QPARITY["levels"]), "modes": list(MODES),
           # row 1: the builds (and any §4.2 rebuild); row 2: the
           # ops' frontier folds
           **_launches_by_row(rows),
           "all_equal": bool(ok), "seconds": time.perf_counter() - t_phase}
    emit(out)
    if not ok:
        raise SystemExit("quotient_parity: the card engine, the CPU engine, "
                         "eval_ref and eval_brute disagree, or a patched "
                         "index differs from a rematerialized one")
    return out


def _full_queries(g, rng, k: int, n_paths: int, n_points: int) -> list:
    """``n_paths`` path queries at level k in k buckets of hop counts
    (one wave each at the phase's batch): realizable random walks, one in
    eight a `LabelPath`, the rest `ReachTemplate`s with a source and a
    target label; then ``n_points`` point lookups."""
    from repro_torch.quotient import LabelPath, PointLookup, ReachTemplate
    off, qs = g.out_offsets(), []
    for i in range(n_paths):
        hops = 1 + i * k // n_paths
        p = _walk_labels(g, off, rng, hops)
        if i % 8 == 0:
            qs.append(LabelPath(p, level=k))
        else:
            qs.append(ReachTemplate(p, src_label=int(rng.integers(0, 4)),
                                    tgt_label=int(rng.integers(0, 4)),
                                    level=k))
    qs += [PointLookup(int(n), int(lv)) for n, lv in zip(
        rng.integers(0, g.num_nodes, n_points),
        rng.integers(1, k + 1, n_points))]
    return qs


def _timed_waves(svc, queries) -> tuple:
    """One pass of ``queries`` through the service's engine as it runs:
    its `_init_mask` and `_hop` calls bracketed by CUDA events (a wave's
    device ms from its endpoint mask through its last hop, each hop's),
    its own spans on the host clock (``quotient.wave_mask``: the want
    upload, the hops and the mask's transfer; ``quotient.query_wave``:
    with the answers' expansion).  Returns the answers and one dict a
    wave."""
    import torch
    from repro_torch import obs
    from repro_torch.quotient import engine as qe
    init, hop, marks = qe._init_mask, qe._hop, []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed_init(*args, **kwargs):
        start = event()
        out = init(*args, **kwargs)
        marks.append([start, event()])
        return out

    def timed_hop(*args, **kwargs):
        out = hop(*args, **kwargs)
        marks[-1].append(event())
        return out

    qe._init_mask, qe._hop = timed_init, timed_hop
    try:
        with obs.tracing() as tracer:
            answers = svc.query(queries)
    finally:
        qe._init_mask, qe._hop = init, hop
    torch.cuda.synchronize()
    waves = []
    for span, mask, ev in zip(tracer.find("quotient.query_wave"),
                              tracer.find("quotient.wave_mask"), marks):
        j, m = span["attrs"]["level"], span["attrs"]["hops"]
        waves.append({
            "level": j, "hops": m, "batch": span["attrs"]["batch"],
            "wave_device_ms": ev[0].elapsed_time(ev[-1]),
            "hop_device_ms": {j - m + 1 + i: ev[1 + i].elapsed_time(
                ev[2 + i]) for i in range(m)},
            "wave_mask_host_ms": mask["dur"] / 1e6,
            "wave_host_ms": span["dur"] / 1e6})
    return answers, waves


def _transfers_a_wave(svc, queries) -> dict:
    """Device->host copies the profiler sees over one query batch, and
    the waves the batch took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    engine = svc.engine
    waves0 = engine.stats["waves"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc.query(queries)
        torch.cuda.synchronize()
    waves = engine.stats["waves"] - waves0
    dtoh = sum(e.count for e in prof.key_averages()
               if "DtoH" in e.key or "Device -> Pageable" in e.key)
    return {"waves": waves, "device_to_host_copies": dtoh,
            "per_wave": dtoh / max(waves, 1)}


def phase_quotient(g, quiet=None) -> dict:
    """The quotient engine at full size: an in-memory maintainer on the
    card at k=4 (``sorted``), `QuotientService` materializing with
    2^20-row sort budgets (blocks and edges a level, the wall, its
    `IOStats`, the engine's device bytes), 32 path queries (8 a hop
    count, so one wave each of 64 fixed slots) and 64 point lookups,
    every answer equal to `eval_ref`'s and a seeded 16 of them to
    `eval_brute`'s on the original graph; then 1,000 inserts absorbed by
    the service (patch ms, levels touched, kernel launches:
    ``sig_fold.launches`` set to 0 just before the build and each op and
    read just after, counted by `_launches_by_row`), and the same
    queries on the patched index (their `eval_ref` round is
    cut for time; the timed round must equal them).  Last,
    once ``quiet()`` returns (no other process on the card), the queries
    once more through the engine as it runs, timed (`_timed_waves`; the
    answers must equal the previous round's) and profiled for the
    device->host copies a wave.  Answers average two million node ids
    here, and their host expansion (shared by the engine and `eval_ref`)
    sets the query count and the rounds."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import BisimMaintainer
    from repro_torch.kernels.sig_fold import sig_fold
    from repro_torch.launch import bisim as launcher
    from repro_torch.quotient import QuotientService, eval_brute, eval_ref
    t_phase = time.perf_counter()
    k, rng = QUOTIENT["k"], np.random.default_rng(QUOTIENT["seed"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sig_fold.launches = 0
    t0 = time.perf_counter()
    m = BisimMaintainer(g, k, mode=QUOTIENT["mode"], device=DEVICE)
    torch.cuda.synchronize()
    build_s, build_launches = time.perf_counter() - t0, sig_fold.launches
    t0 = time.perf_counter()
    svc = QuotientService(m, str(QUOTIENT_WORKDIR / "full"),
                          max_batch=QUOTIENT["batch"],
                          budget_rows=QUOTIENT["budget_rows"])
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    idx, engine = svc.index, svc.engine
    out = {"phase": "quotient", "op": "materialize", "k": k,
           "mode": QUOTIENT["mode"], "build_s": build_s,
           "sig_fold_launches": build_launches,
           "budget_rows": QUOTIENT["budget_rows"], "materialize_s": mat_s,
           "blocks": idx.counts[1:],
           "edges": [idx.levels[j].num_edges for j in range(1, k + 1)],
           "io": svc.io.to_dict(), "device_bytes": engine.device_bytes,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    queries = _full_queries(g, rng, k, QUOTIENT["path_queries"],
                            QUOTIENT["point_lookups"])

    def serve(tag, brute=False, ref=True) -> tuple:
        """The batch through the engine (host clock), each answer
        against eval_ref (unless not ``ref``), a sample against
        eval_brute."""
        stats0 = dict(engine.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers = svc.query(queries)
        query_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_equal = all(_same_answers(a, eval_ref(svc.index, q))
                        for a, q in zip(answers, queries)) if ref else None
        ref_s = time.perf_counter() - t0
        sample = (rng.choice(len(queries), QUOTIENT["brute_sample"],
                             replace=False) if brute else [])
        hist = _brute_hist(m)
        t0 = time.perf_counter()
        brute_equal = all(_same_answers(
            answers[i], eval_brute(m.graph, queries[i], hist))
            for i in sample)
        brute_s = time.perf_counter() - t0
        sizes = [a.shape[0] for a in answers if isinstance(a, np.ndarray)]
        return answers, {
            "tag": tag, "epoch": engine.epoch,
            "stats": {key: engine.stats[key] - stats0[key]
                      for key in engine.stats},
            "query_s": query_s,
            "answer_nodes": {"sum": int(sum(sizes)), "max": int(max(sizes))},
            "eval_ref_equal": ref_equal, "eval_ref_s": ref_s,
            "eval_brute_sample": int(len(sample)),
            "eval_brute_equal": brute_equal, "eval_brute_s": brute_s}

    _, first = serve("materialized", brute=True)
    emit({"phase": "quotient", "op": "query", **first})
    rows, ok = [first], (first["eval_ref_equal"] and first["eval_brute_equal"]
                         and first["eval_brute_sample"] > 0)
    for op, count in QUOTIENT["ops"]:
        sig_fold.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        io0 = svc.io.to_dict()
        t0 = time.perf_counter()
        with obs.tracing() as tracer:
            rep = _service_op(svc, op, count, rng, launcher)
        torch.cuda.synchronize()
        op_s = time.perf_counter() - t0
        launches, rebuilt = sig_fold.launches, bool(rep.rebuilt)
        patch = tracer.find("quotient.patch")
        io1 = svc.io.to_dict()
        row = {"phase": "quotient", "op": op, "count": count,
               "op_s": op_s,
               "patch_ms": patch[0]["dur"] / 1e6 if patch else None,
               "levels_touched": [j for j, c in enumerate(m.last_changed
                                                          or [])
                                  if j and len(c)],
               "frontier": rep.nodes_checked, "rebuilt": rebuilt,
               "patches": svc.patches,
               "rematerializations": svc.rematerializations,
               "sig_fold_launches": launches,
               "io_delta": {key: io1[key] - io0[key] for key in io1},
               "edges": [svc.index.levels[j].num_edges
                         for j in range(1, k + 1)],
               "device_bytes": engine.device_bytes,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        emit(row)
        rows.append(row)
    del tracer
    # the queries again on the index patched by every op, held to the
    # timed round below; their eval_ref round is cut for the script's
    # time (quotient_parity holds patched indexes to eval_ref and
    # eval_brute, and a patched index to a rematerialized one)
    last, again = serve(f"after {len(QUOTIENT['ops'])} patches", ref=False)
    emit({"phase": "quotient", "op": "query", **again})
    if quiet is not None:
        quiet()
    answers, waves = _timed_waves(svc, queries)
    transfers = _transfers_a_wave(
        svc, [q for q in queries if getattr(q, "labels", None)
              and len(q.labels) == k][:QUOTIENT["batch"]])
    timed = {"phase": "quotient", "op": "timed query",
             "epoch": engine.epoch, "waves": waves, "transfers": transfers,
             "equal_previous_round": all(map(_same_answers, answers, last))}
    emit(timed)
    ok &= timed["equal_previous_round"] and transfers["per_wave"] == 1
    del answers, last
    res = {"phase": "quotient",
           "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                     "edges": g.num_edges},
           **_launches_by_row([out] + rows[1:]),
           "patched": any(r.get("patches") for r in rows[1:]),
           "ok": bool(ok), "seconds": time.perf_counter() - t_phase}
    emit(res)
    del svc, m, engine, idx
    torch.cuda.empty_cache()
    shutil.rmtree(QUOTIENT_WORKDIR / "full", ignore_errors=True)
    if not (ok and res["frontier_sig_fold_launches"] and res["patched"]):
        raise SystemExit("quotient: answers differ from eval_ref, "
                         "eval_brute or the previous round, a wave made "
                         "other than one transfer, or no patch went "
                         "through frontier_sig_fold")
    return res


def _stream_argv(device: str, workdir, kill_at: int = 0) -> list:
    argv = ["--device", device, "--generator", "powerlaw", "--nodes",
            str(PARITY["nodes"]), "--edges", str(PARITY["edges"]), "--k",
            str(STREAM["k"]), "--mode", STREAM["mode"], "--oocore", "--wal",
            "--workdir", str(workdir), "serve-updates", "--ops",
            str(STREAM["ops"])]
    # the drill snapshots every 2 batches: the launcher's cadence (8) took
    # no snapshot by op 120, and recovery needs one to start from
    return argv + (["--kill-at-op", str(kill_at), "--snapshot-every",
                    str(STREAM["drill_snapshot_every"])] if kill_at else [])


def stream_worker(device: str, workdir: str, kill_at: int,
                  out_path: str) -> int:
    """One ``serve-updates`` run through the launcher (in a worker
    process): its kernel counts set to 0 just before and read just after
    (a drill's cover its three runs); the final pid history, stats and
    counts go to ``out_path``."""
    import numpy as np
    import torch
    from repro_torch.kernels.sig_fold import chunk_sig_fold, sig_fold
    from repro_torch.launch import bisim as launcher
    args = launcher.build_parser().parse_args(
        _stream_argv(device, workdir, kill_at))
    if (args.ops, args.batch_ops) != (STREAM["ops"], STREAM["batch_ops"]):
        raise SystemExit("the launcher's serve-updates batches moved")
    sig_fold.launches = chunk_sig_fold.launches = 0
    t0 = time.perf_counter()
    res = launcher.main(_stream_argv(device, workdir, kill_at))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = {"device": device, "kill_at": kill_at, "wall_s": wall,
            "stats": res["stats"], "ref_stats": res.get("ref_stats"),
            "next_pid": res["next_pid"],
            "frontier_sig_fold_launches": sig_fold.launches,
            "chunk_sig_fold_launches": chunk_sig_fold.launches,
            "survived": res.get("survived")}
    np.savez(out_path, info=np.array(json.dumps(info)),
             **{f"pids_{j}": p for j, p in enumerate(res["pids"])},
             **{f"ref_pids_{j}": p for j, p in
                enumerate(res.get("ref_pids", []))})
    return 0


def run_worker(argv: list) -> int:
    """A worker process: ``parity`` runs `phase_ooc_maintenance_parity`
    and then `phase_quotient_parity`; ``quotient`` runs `phase_quotient`
    on the full graph (the JSON lines of both go to their logs; it times
    its waves once a line arrives on its standard input); ``stream DEVICE
    WORKDIR KILL_AT OUT``
    one `stream_worker` run; ``dist_parity OUT_DIR`` one rank of
    `dist_parity_worker`; ``dist_launch OUT_DIR ARGV...`` one rank of
    `dist_launch_worker`; ``sharded OUT_DIR`` one rank of
    `sharded_train_worker`; ``dryrun OUT_DIR`` `dryrun_worker`."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(2)  # the workers share the host's cores
    if argv[0] == "dist_parity":
        return dist_parity_worker(argv[1])
    if argv[0] == "dist_launch":
        return dist_launch_worker(argv[1], argv[2:])
    if argv[0] == "sharded":
        return sharded_train_worker(argv[1])
    if argv[0] == "dryrun":
        return dryrun_worker(argv[1])
    if argv[0] == "parity":
        phase_ooc_maintenance_parity()
        phase_quotient_parity()
        return 0
    if argv[0] == "quotient":
        from repro_torch.launch import bisim as launcher
        g = launcher.make_graph(launcher.build_parser().parse_args(
            _full_argv()))
        phase_quotient(g, quiet=sys.stdin.readline)
        return 0
    device, workdir, kill_at, out_path = argv[1:5]
    return stream_worker(device, workdir, int(kill_at), out_path)


def start_workers(names) -> dict:
    """Start the host-bound runs ``names`` as worker processes of this
    script, each with its log under `WORKER_DIR`: ``parity`` (the
    out-of-core maintenance and quotient parity phases), ``quotient``
    (the full graph's quotient phase), ``drill`` and ``cpu`` (the stream
    phase's card crash drill, ``--kill-at-op``, whose uninterrupted run is
    the stream straight through, and its CPU run) and ``dryrun`` (the
    dry-run's cells, host work only, at a lower priority: it has slack)."""
    for d in (WORKER_DIR, STREAM_WORKDIR):
        d.mkdir(parents=True, exist_ok=True)
    runs = {"parity": ["parity"], "quotient": ["quotient"],
            "dryrun": ["dryrun", str(DRYRUN_DIR)]}
    for name, device, kill_at in (("drill", DEVICE, STREAM["kill_at"]),
                                  ("cpu", "cpu", 0)):
        runs[name] = ["stream", device, str(STREAM_WORKDIR / name),
                      str(kill_at), str(WORKER_DIR / f"{name}.npz")]
    procs = {}
    for name in names:
        log = open(WORKER_DIR / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
             *runs[name]], stdin=subprocess.PIPE, stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT),
            preexec_fn=_lower_priority if name == "dryrun" else None),
            log, time.perf_counter())
    return procs


def _lower_priority() -> None:
    import os
    os.nice(10)


def stop_workers(procs: dict) -> None:
    for proc, log, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdin.close()
        log.close()


def _wait_worker(procs: dict, name: str) -> str:
    """Wait for a worker; its log, or raise with its tail if it failed."""
    proc, log, _ = procs[name]
    rc = proc.wait(timeout=1100)
    log.flush()
    text = (WORKER_DIR / f"{name}.log").read_text()
    if rc != 0:
        raise SystemExit(f"the {name} worker failed (rc {rc}):\n"
                         f"{text[-3000:]}")
    return text


def collect_parity(procs: dict) -> dict:
    """Wait for the parity worker and print its JSON lines here; returns
    the summary of ``quotient_parity``."""
    lines = [json.loads(ln) for ln in _wait_worker(
        procs, "parity").splitlines() if ln.startswith('{"phase"')]
    for line in lines:
        emit(line)
    return [ln for ln in lines if ln["phase"] == "quotient_parity"
            and "all_equal" in ln][-1]


def collect_quotient(procs: dict) -> dict:
    """Let the quotient worker time its waves (no other process uses the
    card by now), then print its JSON lines here; returns the summary of
    ``quotient``."""
    proc = procs["quotient"][0]
    try:
        proc.stdin.write(b"time\n")
        proc.stdin.flush()
    except BrokenPipeError:
        pass  # it has ended: its log says how
    lines = [json.loads(ln) for ln in _wait_worker(
        procs, "quotient").splitlines() if ln.startswith('{"phase"')]
    for line in lines:
        emit(line)
    return lines[-1]


def phase_stream(procs: dict) -> dict:
    """``serve-updates`` (120 ops, the launcher's batches of 32, k=10,
    ``sorted``, ``--oocore --wal``) on the parity graph: the card's crash
    drill killed at op 72 with a snapshot every 2 batches,
    whose uninterrupted run is the stream straight through (updates/s,
    batches, snapshots, staleness against its bound, epoch) and whose
    recovered history must be bit-identical to it (else the launcher
    fails), and a CPU run of the same stream; both card histories must
    equal the CPU's.  The kernel launches are the drill process's, over
    its three runs."""
    import numpy as np
    res = {}
    for name in ("drill", "cpu"):
        tail = _wait_worker(procs, name)[-3000:]
        with np.load(WORKER_DIR / f"{name}.npz") as z:
            info = json.loads(str(z["info"]))
            info["pids"] = [z[f"pids_{j}"] for j in range(STREAM["k"] + 1)]
            info["ref_pids"] = [z[key] for key in sorted(
                (x for x in z.files if x.startswith("ref_pids_")),
                key=lambda x: int(x.split("_")[-1]))]
        info["process_s"] = time.perf_counter() - procs[name][2]
        info["lines"] = [ln for ln in tail.splitlines()
                         if ln.startswith(("stream:", "staleness:", "serve:",
                                           "killed", "recovered:",
                                           "recovery:"))]
        res[name] = info

    def same(a, b) -> bool:
        return len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    cpu, drill = res["cpu"], res["drill"]
    st = drill["ref_stats"]
    out = {"phase": "stream",
           "graph": {"generator": "powerlaw", "nodes": PARITY["nodes"]},
           **STREAM,
           "runs": {name: {key: r[key] for key in (
               "device", "kill_at", "wall_s", "process_s", "stats",
               "ref_stats", "frontier_sig_fold_launches",
               "chunk_sig_fold_launches", "survived", "lines")}
               for name, r in res.items()},
           "updates_per_sec": st["updates_per_sec"],
           "batches": st["applied_batches"], "snapshots": st["snapshots"],
           "max_staleness": st["max_staleness"],
           "staleness_bound": st["staleness_bound"], "epoch": st["epoch"],
           "cpu_updates_per_sec": cpu["stats"]["updates_per_sec"],
           "chunk_sig_fold_launches": drill["chunk_sig_fold_launches"],
           "frontier_sig_fold_launches": drill["frontier_sig_fold_launches"],
           "card_eq_cpu": same(drill["ref_pids"], cpu["pids"]),
           "drill_recovered_eq_uninterrupted": same(drill["pids"],
                                                    drill["ref_pids"]),
           "drill_eq_cpu": same(drill["pids"], cpu["pids"])
           and drill["next_pid"] == cpu["next_pid"],
           "cpu_launches": (cpu["frontier_sig_fold_launches"],
                            cpu["chunk_sig_fold_launches"])}
    out["ok"] = bool(
        out["card_eq_cpu"] and out["drill_recovered_eq_uninterrupted"]
        and out["drill_eq_cpu"] and out["cpu_launches"] == (0, 0)
        and all(s["max_staleness"] <= s["staleness_bound"]
                for s in (st, drill["stats"], cpu["stats"]))
        and drill["chunk_sig_fold_launches"] > 0
        and drill["frontier_sig_fold_launches"] > 0)
    emit(out)
    if not out["ok"]:
        raise SystemExit("stream: a card history differs from the CPU's, "
                         "the drill did not recover bit-identically, the "
                         "staleness bound broke, or a kernel never ran")
    return out


# the distributed build (`repro_torch.core.build_bisim_distributed`):
# ``distributed_parity`` on the parity graph in three groups (one rank on
# the card under NCCL, in this process; eight gloo ranks, each building on
# the CPU and then on the one card), ``distributed`` on the full graph
# through the launcher under torchrun (runs: name, ranks, backend,
# ranking)
DIST = dict(parity_ranks=8, rankings=("allgather", "bucketed"),
            runs=(("d1_nccl_allgather", 1, "nccl", "allgather"),
                  ("d4_gloo_bucketed", 4, "gloo", "bucketed")))
DIST_DIR = ROOT / "build" / "dist-smoke"  # graph copy, rank logs; removed


def _rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for rank ``rank`` of ``world`` on this host."""
    import os
    return {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _instrument_collectives(log: list):
    """Wrap the distributed build's collectives: each call appends (name,
    bytes it leaves in this rank's output, timer) to ``log``; the timer is
    a pair of CUDA events on a card tensor, host seconds on a CPU one.
    Returns the undo."""
    import torch
    from repro_torch.core import distributed as dmod
    saved = {n: getattr(dmod, n) for n in ("_all_gather", "_all_to_all",
                                           "_all_reduce")}

    def wrap(name, fn):
        def timed(t, group):
            if t.is_cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(t, group)
                ev[1].record()
            else:
                t0 = time.perf_counter()
                out = fn(t, group)
                ev = time.perf_counter() - t0
            log.append((name, out.numel() * out.element_size(), ev))
            return out
        return timed
    for n, fn in saved.items():
        setattr(dmod, n, wrap(n, fn))
    return lambda: [setattr(dmod, n, fn) for n, fn in saved.items()]


def _collective_summary(log: list, iterations: int) -> dict:
    """Collective ms and bytes a rank-iteration, and by collective."""
    by = {}
    for name, nbytes, ev in log:
        ms = ev[0].elapsed_time(ev[1]) if isinstance(ev, tuple) else ev * 1e3
        d = by.setdefault(name.strip("_"), {"calls": 0, "ms": 0.0,
                                            "bytes": 0})
        d["calls"] += 1
        d["ms"] += ms
        d["bytes"] += nbytes
    it = max(iterations, 1)
    return {"collective_ms_per_iteration": sum(
        d["ms"] for d in by.values()) / it,
        "collective_bytes_per_iteration": sum(
            d["bytes"] for d in by.values()) / it,
        "collectives": by}


def _measured(build, device: str):
    """``build()`` with its launches, peak card memory and collectives
    measured: (result, info)."""
    import torch
    from repro_torch.kernels.sig_fold import sig_fold
    log = []
    undo = _instrument_collectives(log)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sig_fold.launches = 0
        t0 = time.perf_counter()
        res = build()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sig_fold.launches
    finally:
        undo()
    iterations = len(res.counts) - 1
    return res, {"device": device, "wall_s": wall,
                 "iteration_ms": [s.seconds * 1e3 for s in res.stats[1:]],
                 "iterations": iterations, "fold_flat_launches": launches,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 **_collective_summary(log, iterations)}


def dist_parity_worker(out_dir: str) -> int:
    """One rank of ``distributed_parity``'s gloo group (torchrun's
    variables in its environment): every mode and ranking on the parity
    graph on the CPU, then on the card; writes its results (pids from
    rank 0 only) to ``out_dir``."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import build_bisim_distributed
    from repro_torch.graph import generators as gen
    from repro_torch.launch.cluster import init_cluster
    rank, world = init_cluster(device=DEVICE, backend="gloo")
    g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3, seed=0)
    infos, arrays = {}, {}
    for device in ("cpu", DEVICE):
        for mode in MODES:
            for ranking in DIST["rankings"]:
                key = f"{device}/{mode}/{ranking}"
                res, infos[key] = _measured(
                    lambda: build_bisim_distributed(
                        g, PARITY["k"], mode=mode, ranking=ranking,
                        device=device), device)
                infos[key].update(counts=res.counts,
                                  converged_at=res.converged_at)
                if rank == 0:
                    arrays[key] = res.pids
    dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             info=np.array(json.dumps(infos)), **arrays)
    return 0


def dist_launch_worker(out_dir: str, argv: list) -> int:
    """One rank of a ``distributed`` run under torchrun: the launcher's
    ``main(argv)`` measured as `_measured` measures a build; every rank
    writes its numbers, rank 0 also the pid history."""
    import os
    import numpy as np
    from repro_torch.launch import bisim as launcher
    rank = int(os.environ["RANK"])
    res, info = _measured(lambda: launcher.main(argv), DEVICE)
    np.savez(Path(out_dir) / f"rank{rank}.npz", info=np.array(json.dumps(
        {**info, "counts": res.counts, "converged_at": res.converged_at})),
        **({"pids": res.pids} if rank == 0 else {}))
    return 0


def _run_ranks(name: str, procs: list, log_paths: list, timeout: float):
    """Wait for a run's processes; raise with a failing one's log tail."""
    for proc, path in zip(procs, log_paths):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise SystemExit(f"{name}: {path.name} timed out")
        if rc != 0:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            raise SystemExit(f"{name}: {path.name} failed (rc {rc}):\n"
                             f"{path.read_text()[-3000:]}")


def _load_ranks(out_dir: Path, world: int):
    """Every rank's info and rank 0's arrays of a run."""
    import numpy as np
    infos, arrays = [], {}
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as z:
            infos.append(json.loads(str(z["info"])))
            if r == 0:
                arrays = {key: z[key] for key in z.files if key != "info"}
    return infos, arrays


def _run_line(infos: list) -> dict:
    """One run's line: rank 0's per-iteration ms, every rank's collective
    ms and bytes a rank-iteration, peak card memory and fold launches."""
    return {"iteration_ms": infos[0]["iteration_ms"],
            "counts": infos[0]["counts"],
            "converged_at": infos[0]["converged_at"],
            **{key: [info[key] for info in infos] for key in (
                "wall_s", "collective_ms_per_iteration",
                "collective_bytes_per_iteration", "peak_bytes",
                "fold_flat_launches")},
            "collectives_rank0": infos[0]["collectives"]}


def phase_distributed_parity() -> dict:
    """The distributed build on the parity graph, every mode and both
    rankings, in three groups: eight gloo ranks (processes of this
    script) building on the CPU and on the one card, and one NCCL rank on
    the card in this process.  Bit for bit: card D=8 = CPU D=8, card D=1
    ``allgather`` = CPU D=8 ``allgather`` (= card D=1 ``bucketed``); every
    run's counts are the single-card build's and each level the same
    partition; the card folds through ``fold_flat`` once an iteration."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core import build_bisim, build_bisim_distributed
    from repro_torch.graph import generators as gen
    from repro_torch.launch.cluster import init_cluster
    t0 = time.perf_counter()
    out_dir = DIST_DIR / "parity"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    world, port = DIST["parity_ranks"], _free_port()
    logs = [out_dir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                 "dist_parity", str(out_dir)], stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT),
                env=_rank_env(r, world, port)))
    try:
        g = gen.powerlaw_graph(PARITY["nodes"], PARITY["edges"], 4, 3,
                               seed=0)
        single = {m: build_bisim(g, PARITY["k"], mode=m, device=DEVICE)
                  for m in MODES}
        one, one_pids = {}, {}
        if init_cluster(device=DEVICE) != (0, 1):
            raise SystemExit("distributed_parity: this process is not a "
                             "one-rank group")
        try:
            for mode in MODES:
                for ranking in DIST["rankings"]:
                    key = f"{mode}/{ranking}"
                    res, one[key] = _measured(
                        lambda: build_bisim_distributed(
                            g, PARITY["k"], mode=mode, ranking=ranking,
                            device=DEVICE), DEVICE)
                    one[key].update(counts=res.counts,
                                    converged_at=res.converged_at)
                    one_pids[key] = res.pids
        finally:
            dist.destroy_process_group()
        _run_ranks("distributed_parity", procs, logs, 600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    infos, pids = _load_ranks(out_dir, world)
    checks, groups = {}, {"card_d1_nccl": {}, "card_d8_gloo": {},
                          "cpu_d8_gloo": {}}
    for mode in MODES:
        ref = single[mode]
        for ranking in DIST["rankings"]:
            key = f"{mode}/{ranking}"
            runs = {"card_d1_nccl": ([one[key]], one_pids[key]),
                    "card_d8_gloo": ([i[f"{DEVICE}/{key}"] for i in infos],
                                     pids[f"{DEVICE}/{key}"]),
                    "cpu_d8_gloo": ([i[f"cpu/{key}"] for i in infos],
                                    pids[f"cpu/{key}"])}
            for group, (run_infos, _) in runs.items():
                groups[group][key] = _run_line(run_infos)
            card8, cpu8 = runs["card_d8_gloo"], runs["cpu_d8_gloo"]
            ok = {"card_d8_eq_cpu_d8": bool(
                np.array_equal(card8[1], cpu8[1])
                and card8[0][0]["counts"] == cpu8[0][0]["counts"]
                and card8[0][0]["converged_at"]
                == cpu8[0][0]["converged_at"])}
            if ranking == "allgather":
                ok["card_d1_eq_cpu_d8"] = bool(np.array_equal(
                    one_pids[key], cpu8[1]))
            else:
                ok["card_d1_eq_d1_allgather"] = bool(np.array_equal(
                    one_pids[key], one_pids[f"{mode}/allgather"]))
            ok["ranks_agree"] = all(
                i["counts"] == run_infos[0]["counts"]
                for run_infos, _ in runs.values() for i in run_infos)
            ok["counts_eq_single"] = all(
                run_infos[0]["counts"] == ref.counts
                for run_infos, _ in runs.values())
            ok["same_partition_every_level"] = all(
                p.shape == ref.pids.shape and all(
                    _same_partition(p[j], ref.pids[j])
                    for j in range(p.shape[0]))
                for _, p in runs.values())
            ok["card_folds_once_an_iteration"] = all(
                i["fold_flat_launches"] == i["iterations"] > 0
                for group in ("card_d1_nccl", "card_d8_gloo")
                for i in runs[group][0])
            ok["cpu_launches_nothing"] = all(
                i["fold_flat_launches"] == 0 for i in cpu8[0])
            checks[key] = ok
    for group, lines in groups.items():
        emit({"phase": "distributed_parity", "group": group,
              "graph": {"generator": "powerlaw", "nodes": g.num_nodes,
                        "edges": g.num_edges}, "k": PARITY["k"],
              "runs": lines})
    out = {"phase": "distributed_parity", "checks": checks,
           "single_counts": {m: single[m].counts for m in MODES},
           "seconds": time.perf_counter() - t0}
    out["ok"] = all(all(v.values()) for v in checks.values())
    emit(out)
    shutil.rmtree(out_dir, ignore_errors=True)
    if not out["ok"]:
        raise SystemExit("distributed_parity: a distributed build differs "
                         "from its twin or from the single-card build, or "
                         "a card run did not fold through fold_flat once "
                         "an iteration")
    return out


def save_full_graph(g) -> Path:
    """The full graph, saved once (uncompressed) for ``--graph``."""
    import numpy as np
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    path = DIST_DIR / "full_graph.npz"
    np.savez(path, node_labels=g.node_labels, src=g.src, dst=g.dst,
             elabel=g.elabel)
    return path


def phase_distributed(graph_path: Path, inmem) -> dict:
    """The launcher's ``--distributed`` build of the full graph under
    ``python -m torch.distributed.run --standalone``: one rank under NCCL
    (``allgather``) and four gloo ranks sharing the card (``bucketed``).
    Each equals the in-memory ``sorted`` build: counts, and the same
    partition at every level; every rank folds through ``fold_flat`` once
    an iteration.  One line a run."""
    lines = {}
    for name, world, backend, ranking in DIST["runs"]:
        out_dir = DIST_DIR / name
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        argv = ["--graph", str(graph_path), "--k", str(FULL["k"]),
                "--mode", "sorted", "--device", DEVICE, "--distributed",
                "--ranking", ranking, "--dist-backend", backend]
        log = out_dir / "torchrun.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(world),
                 str(ROOT / "chip_smoke.py"), "--worker", "dist_launch",
                 str(out_dir), *argv], stdout=f, stderr=subprocess.STDOUT,
                cwd=str(ROOT))
        _run_ranks(f"distributed {name}", [proc], [log], 600)
        infos, arrays = _load_ranks(out_dir, world)
        pids = arrays["pids"]
        text = log.read_text()
        line = {"phase": "distributed", "run": name, "ranks": world,
                "backend": backend, "ranking": ranking, "mode": "sorted",
                "k": FULL["k"], "process_s": time.perf_counter() - t0,
                **_run_line(infos),
                "launcher_lines": [ln for ln in text.splitlines() if
                                   ln.startswith(("graph:", "k=", "  iter",
                                                  "total"))],
                "counts_eq_inmemory": infos[0]["counts"] == inmem.counts,
                "same_partition_every_level": pids.shape == inmem.pids.shape
                and all(_same_partition(pids[j], inmem.pids[j])
                        for j in range(pids.shape[0])),
                "ranks_agree": all(i["counts"] == infos[0]["counts"]
                                   for i in infos),
                "folds_once_an_iteration": all(
                    i["fold_flat_launches"] == i["iterations"] > 0
                    for i in infos)}
        line["ok"] = bool(line["counts_eq_inmemory"]
                          and line["same_partition_every_level"]
                          and line["ranks_agree"]
                          and line["folds_once_an_iteration"])
        emit(line)
        shutil.rmtree(out_dir, ignore_errors=True)
        if not line["ok"]:
            raise SystemExit(f"distributed {name}: differs from the "
                             "in-memory build, or a rank did not fold "
                             "through fold_flat once an iteration")
        lines[name] = line
    return lines


# b, hq, hkv, sq, skv, d, causal, window, softcap, dtype: the JAX
# package's attention test cases (`tests/test_kernels.py::ATTN_CASES`),
# then odd lengths as serving prompts have them (the Pallas wrapper
# refuses them), at head_dims 64 and 256; then the bf16 kernel's cases of
# `tests/test_torch_kernels_gpu.py`: every head_dim (causal, and
# non-causal with softcap), ragged lengths, GQA groups 1, 2 and 8, window
# and softcap each on and off
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, None, "float32"),
    (1, 8, 1, 256, 256, 32, True, None, 30.0, "float32"),
    (2, 2, 2, 128, 256, 64, True, 64, None, "float32"),
    (1, 4, 4, 128, 128, 128, False, None, None, "float32"),
    (1, 2, 1, 128, 128, 64, True, None, None, "bfloat16"),
    (1, 2, 2, 64, 64, 16, True, 32, 20.0, "float32"),
] + [case for sq, skv in ((37, 37), (1, 300), (37, 300)) for case in (
    (2, 4, 2, sq, skv, 64, True, None, None, "float32"),
    (2, 16, 8, sq, skv, 256, True, 16, 50.0, "bfloat16"),
    (1, 16, 8, sq, skv, 256, True, 16, 50.0, "float32"))] + [
    (1, 4, 2, 200, 200, d, True, None, None, "bfloat16") for d in HEAD_DIMS
] + [(1, 4, 4, 256, 256, d, False, None, 30.0, "bfloat16")
     for d in HEAD_DIMS] + [
    (2, 4, 2, sq, skv, 64, True, 16, 50.0, "bfloat16")
    for sq, skv in ((1, 300), (37, 37), (37, 300), (300, 300))
] + [(1, hq, hkv, 150, 250, 128, True, None, None, "bfloat16")
     for hq, hkv in ((4, 4), (4, 2), (8, 1))] + [
    (1, 4, 2, 300, 300, 256, True, window, softcap, "bfloat16")
    for window in (None, 100) for softcap in (None, 50.0)]
# gemma2-9b's prefill attention: one sequence of 8192 tokens in bf16
GEMMA_ATTN = dict(b=1, hq=16, hkv=8, s=8192, d=256, softcap=50.0,
                  window=4096)
# the serve-parity model: gemma2 cut to 4 layers at a moderate width
PARITY_LM = dict(num_layers=4, d_model=512, num_heads=8, num_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32768, local_window=32)
# multi-head latent attention: the (q/k, v) head_dim pairs built for it,
# minicpm3-4b's, its smoke configuration's and deepseek-v2-lite's; the
# pairs' cases against the plain version in both dtypes (b, hq, hkv, sq,
# skv, (d, dv), causal, window, softcap, dtype); minicpm3-4b's MLA prefill
# attention (40 q over 40 kv heads, q/k of 64 nope + 32 rope, v of 64, one
# sequence of 8192 tokens in bf16) and, smaller, in f32; deepseek-v2-lite's
# the same way (16 over 16 heads, q/k of 128 nope + 64 rope, v of 128)
MLA_PAIRS = ((96, 64), (24, 16), (192, 128))
# zamba2-7b's head_dim 112 (its shared attention block), built in the
# square libraries: its cases beside MLA's pairs', and zamba2's prefill
# attention (32 q over 32 kv heads, one sequence of 8192 tokens in bf16)
HD112 = (112, 112)
PAIRS = MLA_PAIRS + (HD112,)
MLA_ATTN_CASES = [(c[:5] + (pair,) + c[5:] + (dtype,))
                  for pair in PAIRS for dtype in ("float32", "bfloat16")
                  for c in ((1, 4, 4, 200, 200, True, None, None),
                            (2, 8, 2, 37, 300, False, 64, 2.0),
                            (1, 4, 1, 150, 250, True, None, None))]
MLA_ATTN = dict(b=1, hq=40, hkv=40, s=8192, d=96, dv=64)
DEEPSEEK_ATTN = dict(b=1, hq=16, hkv=16, s=8192, d=192, dv=128)
ZAMBA_ATTN = dict(b=1, hq=32, hkv=32, s=8192, d=112, dv=112)
MLA_F32_TOKENS = 1024
# seamless-m4t-large-v2's attention (16/16 heads of 64, non-causal): the
# encoder's self-attention over its 4,096 frames; the cross-attention of
# prefill_32k's 32,768 decoder positions over them in bf16 (the plain
# version checks and is timed on query slices of 8,192 rows, whose logits
# fit: the rows of a non-causal call are independent) and of 8,192 in
# f32 and for the backward; and a decode step's cross-attention, 4 rows
# of one query over the frames (one real row in the bf16 kernel's
# 128-row tile)
SEAMLESS_ATTN = dict(h=16, d=64, frames=4096, prefill=32768,
                     plain_rows=8192, train_queries=8192, decode_rows=4)
# the non-causal cases with Sq > Skv, Sq = 1 and Sq = Skv against the plain
# version in the backward's check (and the forwards' lse there), those of
# `tests/test_torch_kernels_gpu.py::CROSS_CASES` (b, hq, hkv, sq, skv, d,
# causal, window, softcap, q_offset: None the default Skv - Sq)
CROSS_BWD_CASES = [
    (2, 4, 4, 40, 24, 16, False, None, None, None),
    (4, 16, 16, 1, 4096, 64, False, None, None, None),
    (2, 4, 4, 1, 24, 16, False, None, None, None),
    (1, 8, 2, 1, 300, 64, False, None, None, 0),
    (1, 16, 16, 300, 128, 64, False, None, None, None),
    (2, 8, 2, 200, 70, 64, False, None, 2.0, 0),
    (1, 16, 16, 1000, 300, 64, False, None, None, None),
    (1, 4, 1, 129, 64, 128, False, None, None, None),
    (1, 16, 16, 512, 512, 64, False, None, None, None),
]
# the MLA serve-parity model: minicpm3-4b cut to 4 layers at d_model 512,
# its own head widths
PARITY_MLA = dict(num_layers=4, d_model=512, num_heads=8, num_kv_heads=8,
                  kv_lora_rank=256, q_lora_rank=768, rope_head_dim=32,
                  nope_head_dim=64, v_head_dim=64, head_dim=64, d_ff=2048,
                  vocab_size=32768)
# the MoE serve-parity models at d_model 512 with their own head widths and
# experts: llama4-scout cut to 4 layers (GQA 8/2 heads of 128; 16 experts,
# top-1, one shared) and deepseek-v2-lite to 2 (MLA over 8 heads, q/k 128
# nope + 64 rope, v 128, kv_lora 512, no q_lora; 64 experts, top-6, two
# shared; its CPU side took 12-20 s at 4); both serve fewer, shorter
# requests than the dense parities (`PARITY_MOE_TRAFFIC`): the dense
# dispatch multiplies the 128 slots of every expert at each decode step,
# which the CPU's side pays for
PARITY_LLAMA4 = dict(num_layers=4, d_model=512, num_heads=8, num_kv_heads=2,
                     head_dim=128, num_experts=16, moe_top_k=1,
                     num_shared_experts=1, d_ff=2048, vocab_size=32768)
PARITY_DEEPSEEK = dict(num_layers=2, d_model=512, num_heads=8,
                       num_kv_heads=8, kv_lora_rank=512, q_lora_rank=0,
                       rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
                       head_dim=128, num_experts=64, moe_top_k=6,
                       num_shared_experts=2, d_ff=1408, vocab_size=32768)
PARITY_MOE_TRAFFIC = dict(lengths=(5, 40, 70), max_new=4)
# the SSM serve-parity models at d_model 512 with their own state widths:
# mamba2 cut to 4 layers, zamba2 to 6 (2 groups of ssm, ssm, ssm_attn) with
# the shared block's head_dim 112 (4/4 heads), so that the (112, 112) f32
# kernels run on its path
PARITY_MAMBA2 = dict(num_layers=4, d_model=512, vocab_size=32768)
PARITY_ZAMBA2 = dict(num_layers=6, d_model=512, num_heads=4, num_kv_heads=4,
                     head_dim=112, d_ff=2048, vocab_size=32768)
# the encoder-decoder's serve parity: seamless-m4t cut to 4 encoder + 4
# decoder layers at d_model 512, 8/8 heads of the full model's head_dim 64,
# 512 frames, f32
PARITY_ENCDEC = dict(num_layers=4, encoder_layers=4, d_model=512,
                     num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048,
                     vocab_size=32768, source_len=512)
# the serve parities that add one train step's gradients on their own
# layers, and its decoder positions: deepseek's f32 backward at (192, 128);
# zamba2's at (112, 112), its shared block's gradient summed over its 2
# ssm_attn layers; seamless's at (64, 64), 1,024 positions over its 512
# frames (non-causal Sq > Skv), dk and dv flowing into the encoder
PARITY_TRAIN_SEQ = {"deepseek_v2_lite_16b": 64, "zamba2_7b": 64,
                    "seamless_m4t_large_v2": 1024}
# gemma2-9b's full-width serve, cut from 42 to 12 layers (6 local/global
# pairs: the pattern takes an even count) for the script's time limit (at
# 22 layers the serve and its profiled wave took 72-73 s)
SERVE_LAYERS = 12


def _kernel_name(mangled: str) -> str:
    """The unqualified name of a kernel from its mangled symbol: the last
    identifier of its nested name, template arguments skipped."""
    if not mangled.startswith("_ZN"):
        return mangled
    names, i = [], 3
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            n = int(mangled[i:j])
            names.append(mangled[j:j + n])
            i = j + n
        elif mangled[i] == "I":  # template arguments: I ... E, L ... E
            depth = 0
            while True:
                depth += {"I": 1, "L": 1, "E": -1}.get(mangled[i], 0)
                i += 1
                if depth == 0:
                    break
        else:
            i += 1
    return names[-1] if names else mangled


def _sass_summary(name: str, path=None) -> dict:
    """Per kernel of a built library (``path``, default the library
    ``name`` builds to), keyed by its name and head_dims, from its SASS
    (``cuobjdump``): the registers it touches, spill stores and loads,
    wgmma and the waits on them, mma.sync (``HMMA``: the f32 kernels'
    3xTF32 products), the instruction count and a digest of the
    instructions (offsets and encodings left out), which tells two builds
    of one kernel apart.  Under ``setmaxnreg`` this is what ``-Xptxas -v``
    cannot show: it prints only the registers at entry."""
    import hashlib
    import re
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {"cuobjdump": "not found beside nvcc: not measured"}
    sass = subprocess.run([str(tool), "-sass",
                           str(path or _build.library_path(name))],
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        fn = block.split()[0]
        dims = re.findall(r"L[ib](\d+)E", fn)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", block)]
        code = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln.split(";")[0]).strip()
                for ln in block.splitlines() if ";" in ln and "/*" in ln]
        key = _kernel_name(fn) + (f" D={'/'.join(dims)}" if dims else "")
        out[key] = {
            "registers_touched": max(regs, default=-1) + 1,
            "STL": block.count("STL"), "LDL": block.count("LDL"),
            "HGMMA": block.count("HGMMA"), "HMMA": block.count("HMMA"),
            "wgmma_waits": block.count("WARPGROUP.DEPBAR"),
            "instructions": len(code),
            "digest": hashlib.sha256(
                "\n".join(code).encode()).hexdigest()[:16]}
    return out


# SDPA's backends that take a v head_dim other than q's and k's (the math
# backend, which materializes the logits, is left out)
SDPA_DV_BACKENDS = ("EFFICIENT_ATTENTION", "FLASH_ATTENTION",
                    "CUDNN_ATTENTION")


def _sdpa_ms(fn, backends=None, reps: int = 10) -> tuple:
    """(ms of ``fn``, a note): SDPA as it picks its backend, or restricted
    to ``backends`` (names of `torch.nn.attention.SDPBackend`); (None, the
    reason) when none of them takes the call's shapes."""
    if backends is None:
        return cuda_ms(fn, reps), None
    from torch.nn.attention import SDPBackend, sdpa_kernel
    chosen = [getattr(SDPBackend, name) for name in backends]

    def restricted():
        with sdpa_kernel(chosen):
            return fn()
    try:
        return cuda_ms(restricted, reps), f"SDPA on {', '.join(backends)}"
    except RuntimeError as exc:
        return None, (f"no SDPA backend among {', '.join(backends)} takes "
                      f"these shapes: {str(exc).splitlines()[0][:200]}")


def _flop_bounds(flops: float, dtype: str) -> tuple:
    """(ms on the kernel's peak, ms on the CUDA cores' f32 peak or None):
    bf16 kernels run on the tensor cores' bf16 peak, f32 kernels in 3xTF32
    on the tensor cores (`FLOP_PER_S` "tf32x3"), their bound, where the
    CUDA-core kernels they replaced had 67 TFLOP/s."""
    if dtype == "float32":
        return (flops / FLOP_PER_S["tf32x3"] * 1e3,
                flops / FLOP_PER_S["float32"] * 1e3)
    return flops / FLOP_PER_S[dtype] * 1e3, None


def _shares(row: dict, time_key: str, prefix: str = "") -> None:
    """A timed row's share of its bound (``<prefix>bound_ms`` over
    ``time_key``) and, for an f32 kernel, of the CUDA-core bound too;
    printed on a line of its own for an f32 row."""
    t = row[time_key]
    row[f"{prefix}share_of_bound"] = row[f"{prefix}bound_ms"] / t
    cuda_core = row.get(f"{prefix}cuda_core_bound_ms")
    if cuda_core is None:
        return
    row[f"{prefix}share_of_cuda_core_bound"] = cuda_core / t
    print(f"f32 {prefix or 'kernel '}{json.dumps(row['case'])}: {t:.4f} ms "
          f"({time_key}), {row[f'{prefix}share_of_bound']:.1%} of the "
          f"3xTF32 bound {row[f'{prefix}bound_ms']:.4f} ms, "
          f"{row[f'{prefix}share_of_cuda_core_bound']:.1%} of the CUDA-core "
          f"bound {cuda_core:.4f} ms", flush=True)


def phase_mma_rate() -> dict:
    """Phase 8b: TFLOP/s of TF32 ``mma.sync`` m16n8k8 at each count of
    accumulator chains (median of 5 timed launches), the best of them, a
    third of it (the f32-accurate 3xTF32 rate) and the data sheet's 495
    over the best (by which the f32 rows' shares of the 3xTF32 bound
    would grow against the reached rate)."""
    import ctypes
    import torch
    lib = ctypes.CDLL(str(MMA_RATE_LIB))
    lib.mma_tf32_loop.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 8192
    out = torch.empty(blocks * 256, dtype=torch.float32, device=DEVICE)

    def launch(nacc):
        err = lib.mma_tf32_loop(nacc, blocks, iters, out.data_ptr())
        if err:
            raise SystemExit(f"mma_rate: launch failed, cudaError {err}")
    rates = {}
    for nacc in MMA_RATE_CHAINS:
        ms = cuda_ms(lambda: launch(nacc), 5)
        flops = blocks * 8 * iters * nacc * 2 * 16 * 8 * 8
        rates[nacc] = flops / ms / 1e9
    best = max(rates.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"phase": "mma_rate",
           "instruction": "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
           "nvidia_smi": smi, "blocks": blocks, "warps_a_block": 8,
           "iters": iters, "tflops_by_chains": rates, "tflops": best,
           "tf32x3_tflops": best / 3,
           "data_sheet_tflops": FLOP_PER_S["tf32x3"] * 3 / 1e12,
           "data_sheet_over_reached": FLOP_PER_S["tf32x3"] * 3e-12 / best}
    emit(res)
    if not all(r > 0 for r in rates.values()):
        raise SystemExit("mma_rate: a rate is not positive")
    return res


def phase_attention() -> dict:
    """flash_attention on the card vs flash_attention_plain on the card,
    each case timed beside its bound and beside SDPA without softcap."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_route)
    from repro_torch.kernels.ref import attention_mask
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)

    def measure(b, hq, hkv, sq, skv, d, causal, window, softcap, dtype,
                bshd=False, profile=False, dv=None, sdpa_backends=None,
                plain_rows=None, relative=False):
        # bshd: [B, S, H, D] activations viewed as [B, H, S, D], as the
        # model hands them over; dv: v's head_dim (MLA), default d;
        # plain_rows: the plain version runs on query slices of that many
        # rows (a non-causal call without a window: rows independent);
        # relative: the output held to its max |o| and the rows' lse to
        # `_fwd_impl`'s port (over 4,096 keys a typical |o| is ~0.02, the
        # size of the absolute bf16 bar)
        dv = dv or d
        q, k, v = (torch.randn(b, s, h, w, generator=gen, device=dev)
                   .to(getattr(torch, dtype)).transpose(1, 2)
                   if bshd else
                   torch.randn(b, h, s, w, generator=gen, device=dev)
                   .to(getattr(torch, dtype))
                   for h, s, w in ((hq, sq, d), (hkv, skv, d),
                                   (hkv, skv, dv)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        launches = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        launched = flash_attention.launches - launches

        def plain():
            if plain_rows is None:
                return flash_attention_plain(q, k, v, **kw)
            assert not causal and window is None
            return torch.cat([flash_attention_plain(
                q[:, :, i:i + plain_rows], k, v, **kw)
                for i in range(0, sq, plain_rows)], dim=2)
        want = plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        bf16 = dtype == "bfloat16"
        tol = 2e-2 if bf16 else 2e-5
        lse_ok, extra = True, {}
        if relative:
            assert not causal and window is None
            tol = (1e-2 if bf16 else 1e-4) * float(want.float().abs().max())
            o_l, lse = flash_attention(q, k, v, return_lse=True, **kw)
            rows = plain_rows or sq
            want_lse = torch.cat([tfa.flash_attention_fwd_plain(
                q[:, :, i:i + rows], k, v, **kw)[1]
                for i in range(0, sq, rows)], dim=2)
            lse_err = float((lse - want_lse).abs().max())
            lse_tol = (1e-3 if bf16 else 1e-4) * max(
                1.0, float(want_lse.abs().max()))
            lse_ok = lse_err <= lse_tol and torch.equal(o_l, got)
            extra = {"lse_max_abs_err": lse_err, "lse_tol": lse_tol}
            del o_l, lse, want_lse
        keep = attention_mask(sq, skv, causal=causal, window=window,
                              device=dev)
        pairs = int(keep.sum())  # unmasked (query, key) pairs of a head
        flop_ms, cuda_core_ms = _flop_bounds(
            tfa.fwd_flops(d, dv, b * hq * pairs), dtype)
        byte_ms = (q.element_size() * (q.numel() + k.numel() + v.numel()
                                       + got.numel())
                   / HBM_BYTES_PER_S * 1e3)
        # the yardstick: one SDPA call, same mask, no softcap (SDPA has
        # none); its is_causal aligns queries top-left, so a boolean mask
        # carries the right-aligned causal and window masks
        sdpa = dict(enable_gqa=True) if hq != hkv or dv == d else {}
        if causal and window is None and sq == skv:
            sdpa["is_causal"] = True
        elif causal or window is not None:
            sdpa["attn_mask"] = keep
        library_ms, library_note = _sdpa_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, **sdpa),
            sdpa_backends)
        row = {"case": dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, dv=dv,
                            causal=causal, window=window, softcap=softcap,
                            dtype=dtype, bshd=bshd),
               "route": kernel_route(q.dtype, d, dv),
               "max_abs_err": err, "tol": tol, **extra,
               "ok": err < tol and launched == 1 and lse_ok
               and got.stride() == tfa._empty_as(q, dv).stride(),
               "pairs_per_head": pairs,
               "ms": cuda_ms(lambda: flash_attention(q, k, v, **kw), 10),
               "plain_ms": cuda_ms(plain, 10),
               "plain_rows": plain_rows,
               "library_ms": library_ms, "library_note": library_note,
               "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "cuda_core_bound_ms": None if cuda_core_ms is None
               else max(cuda_core_ms, byte_ms)}
        if profile:  # the kernel's own device time and the host's share
            fn = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
            names = device_ms_by_name(fn)
            # the card is the slower side here, so events around calls in
            # a row cross-check the profiler, and stand in for it when it
            # saw no launch of the kernel
            b2b = back_to_back_ms(fn)
            fwd = [v["ms"] for name, v in names.items() if "flash_fwd" in name]
            row.update(kernel_ms=sum(fwd) if fwd else b2b,
                       kernel_ms_source="torch.profiler" if fwd
                       else "cuda events, 20 calls in a row",
                       device_ms_by_name=names, back_to_back_ms=b2b,
                       host_us=host_us(fn))
        _shares(row, "kernel_ms" if profile else "ms")
        del q, k, v, got, want, keep, sdpa
        torch.cuda.empty_cache()
        return row

    cases = [measure(*case) for case in ATTN_CASES]
    cases += [measure(2, 4, 2, 37, 37, 64, True, 16, None, dtype, bshd=True)
              for dtype in ("float32", "bfloat16")]
    cases += [measure(*c[:5], c[5][0], *c[6:], dv=c[5][1])
              for c in MLA_ATTN_CASES]
    cases += [measure(2, 8, 8, 100, 100, d, True, None, None, dtype,
                      bshd=True, dv=dv)
              for d, dv in PAIRS for dtype in ("float32", "bfloat16")]

    def mla_prefill(m, backends=SDPA_DV_BACKENDS):
        # a model's heads, bf16 and (shorter) f32; SDPA on the backends
        # that take Dv != D (zamba2's square pair: SDPA as it picks)
        return {dtype: measure(m["b"], m["hq"], m["hkv"], s, s, m["d"],
                               True, None, None, dtype, profile=True,
                               dv=m["dv"], sdpa_backends=backends)
                for dtype, s in (("bfloat16", m["s"]),
                                 ("float32", MLA_F32_TOKENS))}
    mla = mla_prefill(MLA_ATTN)
    deepseek = mla_prefill(DEEPSEEK_ATTN)
    zamba = mla_prefill(ZAMBA_ATTN, None)
    # seamless-m4t-large-v2's heads, non-causal, in the model's [B, S, H,
    # D] layout: the encoder, the cross-attention of prefill_32k and a
    # decode step's
    sm = SEAMLESS_ATTN
    h, d = sm["h"], sm["d"]
    t0 = time.perf_counter()
    seamless = {dtype: {
        "encoder": measure(1, h, h, sm["frames"], sm["frames"], d, False,
                           None, None, dtype, bshd=True, profile=True,
                           relative=True),
        "cross_prefill": measure(
            1, h, h, sm["prefill"] if dtype == "bfloat16"
            else sm["plain_rows"], sm["frames"], d, False, None, None,
            dtype, bshd=True, profile=True, plain_rows=sm["plain_rows"],
            relative=True),
        "cross_decode": measure(sm["decode_rows"], h, h, 1, sm["frames"], d,
                                False, None, None, dtype, bshd=True,
                                profile=True, relative=True)}
        for dtype in ("bfloat16", "float32")}
    seamless_s = time.perf_counter() - t0
    g = GEMMA_ATTN
    timing = {name: measure(g["b"], g["hq"], g["hkv"], g["s"], g["s"],
                            g["d"], True, window, softcap, "bfloat16",
                            profile=True)
              for name, window, softcap in (
                  ("global", None, g["softcap"]),
                  ("local", g["window"], g["softcap"]),
                  ("global_no_softcap", None, None))}
    rows = (cases + list(timing.values()) + list(mla.values())
            + list(deepseek.values()) + list(zamba.values())
            + [r for by in seamless.values() for r in by.values()])
    ptxas = {lib: [ln.strip() for ln in _build.ptxas_report(lib).splitlines()
                   if "Used" in ln or "spill" in ln or "C75" in ln]
             for lib in ("flash_attention", "flash_attention_sm90",
                         "flash_attention_mla", "flash_attention_sm90_mla")}
    routes = {"bfloat16": kernel_route(torch.bfloat16) + " (wgmma, TMA)",
              "float32": kernel_route(torch.float32)
              + " (3xTF32 on the tensor cores, mma.sync)"}
    print(f"flash_attention route: bf16 -> {routes['bfloat16']}, "
          f"f32 -> {routes['float32']}", flush=True)
    for lib, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {lib}: {ln}", flush=True)
    sass = {lib: _sass_summary(lib) for lib in ptxas}
    for lib, kernels in sass.items():
        for kernel, counts in kernels.items():
            print(f"sass {lib} {kernel}: {json.dumps(counts)}", flush=True)
    bad = [c for c in rows if not c["ok"]]
    out = {"phase": "attention", "kernel": "flash_attention",
           "replaces": "src/repro/kernels/flash_attention.py:26 (_kernel "
                       "via flash_attention :78, pallas_call :104)",
           "routes": routes,
           "library": "scaled_dot_product_attention (is_causal, "
                      "enable_gqa) without softcap, boolean mask where the "
                      "mask is not top-left causal",
           "cases": cases, "mismatches": bad,
           "max_abs_err": max(c["max_abs_err"] for c in rows),
           "gemma2_9b_prefill": timing, "minicpm3_4b_prefill": mla,
           "deepseek_v2_lite_16b_prefill": deepseek,
           "zamba2_7b_prefill": zamba,
           "seamless_m4t_large_v2": seamless, "seamless_seconds": seamless_s,
           "built_pairs": [list(p) for p in tfa.HEAD_DIMS],
           "ptxas": ptxas, "sass": sass}
    emit(out)
    if bad:
        raise SystemExit("flash_attention disagrees with its plain version")
    return out


def _host_cpu() -> str:
    """The host's architecture, CPU model and core count."""
    import os
    import platform
    info = Path("/proc/cpuinfo").read_text().splitlines()
    names = sorted({ln.split(":", 1)[1].strip() for ln in info
                    if ln.split(":")[0].strip() in ("model name", "CPU part")})
    return f"{platform.machine()} {' / '.join(names)} x{os.cpu_count()}"


@contextlib.contextmanager
def _pairs_called():
    """A context recording the (library, D, Dv) of each attention kernel
    call (`kernels.flash_attention.library`, which every launch resolves
    through) into the Counter it yields."""
    import collections
    from repro_torch.kernels import flash_attention as tfa
    seen, library = collections.Counter(), tfa.library

    def record(route, d, dv):
        out = library(route, d, dv)
        seen[_pair_key(out[0], d, dv)] += 1
        return out
    tfa.library = record
    try:
        yield seen
    finally:
        tfa.library = library


def _head_dims(cfg) -> tuple:
    """(q/k, v) head_dims of a config's attention."""
    if cfg.attention == "mla":
        return cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def phase_serve_parity(arch: str = "gemma2_9b", overrides=None,
                       phase: str = "serve_parity",
                       trained_scale: bool = False, traffic=None) -> dict:
    """A small ``arch`` (default gemma2 at `PARITY_LM`; minicpm3 at
    `PARITY_MLA` is the MLA one, llama4 and deepseek at `PARITY_LLAMA4`
    and `PARITY_DEEPSEEK` the MoE ones, seamless at `PARITY_ENCDEC` the
    encoder-decoder) served on the card (prefill attention through the
    kernel) and on the CPU (plain version) from one init (with
    ``trained_scale``, its weight matrices at std 1/sqrt(d_in):
    `_trained_scale`) through the serving launcher's waves
    (`launch.serve.run_serve`: an encoder-decoder's stub frames drawn on
    the host from seed 0, the same on both): equal tokens, the launches
    `_expected_launches` counts (a decoder LM's attention layers a
    prefill wave; seamless's 12 a wave and 4 a decode step, its
    cross-attention), every launch through the library built for the
    config's (D, Dv), and the card's prefill logits (2 rows of 70
    tokens, over 2 rows of stub frames) within 1e-4 of the CPU's plain
    route evaluated in float64.  (Card and CPU in f32 each lie ~2e-5 from
    float64 on this model, but their f32 gap depends on the host: 3.1e-5
    on most machines, 9.2e-4 on one, so it is reported beside the host's
    CPU and not held to 1e-4.)  ``traffic`` ({lengths, max_new}) replaces
    the 11 requests of 16 new tokens; an MoE's line adds the assignments
    dropped for capacity in the card's prefills.  An ``arch`` of
    `PARITY_TRAIN_SEQ` adds one train step's gradients on the card
    against float64 (`_train_grads_vs_f64`)."""
    import types

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     kernel_route)
    from repro_torch.launch import serve as launcher
    from repro_torch.models import Model
    from repro_torch.models.params import tree_map
    from repro_torch.serve import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    t0 = time.perf_counter()
    overrides = PARITY_LM if overrides is None else overrides
    cfg = get_config(arch).scaled(**overrides)
    card = Model(cfg).init(0, torch.float32, DEVICE)
    if trained_scale:
        _trained_scale(card.params)
    cpu = Model(cfg).load(tree_map(lambda t: t.cpu(), card.params))
    cpu64 = Model(cfg).load(tree_map(lambda t: t.double(), cpu.params))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 70)))
    # an encoder-decoder's 2 rows of stub frames (the model casts them)
    extra = launcher.wave_inputs(cfg, 2, torch.float32, "cpu") or {}
    on_card = {k: t.to(DEVICE) for k, t in extra.items()}
    logits = {"card": card.prefill(toks.to(DEVICE), **on_card)[0].cpu()
              .double(),
              "cpu": cpu.prefill(toks, **extra)[0].double(),
              "f64": cpu64.prefill(toks, **extra)[0]}
    del cpu64
    err = {f"{a}_vs_{b}": float((logits[a] - logits[b]).abs().max())
           for a, b in (("card", "f64"), ("cpu", "f64"), ("card", "cpu"))}
    # prompts longer than the window of 32, in five length buckets
    lengths = (traffic["lengths"] if traffic else
               (5, 40, 40, 70, 33, 100, 40, 12, 40, 40, 40))
    args = types.SimpleNamespace(max_new=traffic["max_new"] if traffic
                                 else 16)
    reqs = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lengths]
    kw = dict(max_batch=4, max_seq=160)
    flash_attention.launches = 0
    eng = ServeEngine(card, **kw)
    dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
    card.prefill = _counting_drops(card.prefill, dropped)
    try:
        with _pairs_called() as pairs:
            got, _ = launcher.run_serve(args, eng, reqs)
    finally:
        del card.prefill
    launches = flash_attention.launches
    cpu_eng = ServeEngine(cpu, **kw)
    want, _ = launcher.run_serve(args, cpu_eng, reqs)
    d, dv = _head_dims(cfg)
    # the library of the config's (D, Dv); none for an attention-free SSM
    expected = _expected_launches(cfg, eng.stats)
    libs = {_pair_key(kernel_route(torch.float32, d, dv), d, dv)} \
        if expected else set()
    out = {"phase": phase, "arch": arch, "config": overrides,
           "trained_scale": trained_scale, "dtype": "float32",
           "requests": len(reqs), "prompt_lengths": [len(r) for r in reqs],
           "max_new": args.max_new,
           "prefill_logit_max_abs_err": err, "host_cpu": _host_cpu(),
           "tokens_equal": got == want, "stats": vars(eng.stats),
           "stats_equal": eng.stats == cpu_eng.stats,
           "flash_attention_launches": launches,
           "expected_launches": expected,
           "kernel_calls": dict(pairs), "kernel_expected": sorted(libs)}
    if cfg.num_experts:
        out["moe_dropped_in_prefills"] = int(dropped)
    ok = (got == want and eng.stats == cpu_eng.stats
          and err["card_vs_f64"] < 1e-4 and launches == expected
          and set(pairs) == libs)
    if arch in PARITY_TRAIN_SEQ:
        out["train_step"] = _train_grads_vs_f64(cfg, PARITY_TRAIN_SEQ[arch])
        ok = ok and out["train_step"]["ok"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not ok:
        raise SystemExit(f"{phase}: card serving differs from the CPU's")
    return out


def _pair_key(library: str, d: int, dv: int) -> str:
    """The key `_pairs_called` records for a call of ``library`` at
    (d, dv)."""
    return f"{library} D={d}/{dv}"


def _train_grads_vs_f64(cfg, seq: int = 64) -> dict:
    """One train step's loss and gradients of ``cfg`` from seed 0 (weights
    at 1/sqrt(d_in), `_trained_scale`) on a batch of one row of ``seq``
    tokens (an encoder-decoder's with its ``source_len`` frames), in f32
    on the card (the attention forward and backward through their f32
    kernels), against the same parameters' float64 evaluation on the CPU
    (the plain versions): each leaf within 1e-4 of its max |g|, the loss
    within 1e-4 relative; the forward's launches (the remat's count) and
    the backward's (one an attention call of the forward) and the
    libraries they resolved."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model, encdec, lm
    from repro_torch.models.params import tree_map
    params = Model(cfg).init(0, torch.float32, DEVICE).params
    _trained_scale(params)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq)))
             for k in ("tokens", "labels")}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(1, cfg.source_len, cfg.d_model)).astype(np.float32))
        want_fwd, want_bwd = (encdec.remat_forwards(cfg),
                              encdec.prefill_launches(cfg))
    else:
        want_fwd, want_bwd = (lm.remat_forwards(cfg),
                              lm.attention_layers(cfg))
    f64 = Model(cfg).load(tree_map(lambda t: t.detach().cpu().double(),
                                   params), trainable=True)
    train = Model(cfg).load(params, trainable=True)
    fwd = tfa.flash_attention.launches
    bwd = tfa.flash_attention_bwd.launches
    with _pairs_called() as pairs:
        loss, g_card = _grads(train, {k: v.to(DEVICE)
                                      for k, v in batch.items()})
        torch.cuda.synchronize()
    fwd = tfa.flash_attention.launches - fwd
    bwd = tfa.flash_attention_bwd.launches - bwd
    loss64, g64 = _grads(f64, batch)
    errs = _leaf_errors(g_card, g64)
    worst = max(errs, key=errs.get)
    d, dv = _head_dims(cfg)
    want = {_pair_key(tfa.kernel_route(torch.float32, d, dv), d, dv),
            _pair_key(tfa.bwd_kernel_route(torch.float32, d, dv), d, dv)}
    return {"batch": [1, seq], "layers": cfg.num_layers, "loss": loss,
            "loss_f64": loss64,
            "grad_err_of_max": errs[worst], "worst_leaf": worst,
            "shared_grad_err_of_max": {k: v for k, v in errs.items()
                                       if k.startswith("shared/")},
            "encoder_grad_err_of_max": max(
                (v for k, v in errs.items() if k.startswith("enc_")),
                default=None),
            "fwd_launches": fwd, "remat_forwards": want_fwd,
            "bwd_launches": bwd, "kernel_calls": dict(pairs),
            "ok": (errs[worst] <= 1e-4 and bwd == want_bwd
                   and fwd == want_fwd
                   and abs(loss - loss64) <= 1e-4 * abs(loss64)
                   and set(pairs) == want)}


def _timed_host(fn, log: list, finite: list):
    """``fn`` timed by the host clock between two synchronizes (ms into
    ``log``), with whether its first output (logits) is finite."""
    import torch

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        finite.append(bool(torch.isfinite(out[0]).all()))
        return out
    return timed


def phase_serve():
    """The serving launcher's defaults on gemma2-9b at full width, cut to
    `SERVE_LAYERS` layers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    args = launcher.build_parser().parse_args(["--arch", "gemma2_9b",
                                               "--device", DEVICE])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # `launcher.make_engine` on the cut config: random bf16 weights from
    # seed 0, the launcher's max_batch and max_seq
    cfg = get_config(args.arch).scaled(num_layers=SERVE_LAYERS)
    eng = ServeEngine(Model(cfg).init(0, torch.bfloat16, DEVICE),
                      max_batch=args.max_batch, max_seq=args.max_seq,
                      dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, cfg = eng.model, eng.model.cfg
    reqs = launcher.make_requests(cfg, args.requests)
    prefill_ms, decode_ms, finite = [], [], []
    model.prefill = _timed_host(model.prefill, prefill_ms, finite)
    model.decode_step = _timed_host(model.decode_step, decode_ms, finite)
    try:
        flash_attention.launches = 0
        outs, wall = launcher.run_serve(args, eng, reqs)
        launches = flash_attention.launches
    finally:
        del model.prefill, model.decode_step
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    st = eng.stats
    shapes_ok = (len(outs) == len(reqs)
                 and all(len(o) == args.max_new for o in outs)
                 and all(0 <= t < cfg.padded_vocab for o in outs for t in o))
    out = {"phase": "serve", "arch": cfg.name,
           "dtype": str(eng.dtype).removeprefix("torch."),
           "layers": cfg.num_layers, "layers_of": 42,
           "params": model.num_params(),
           "requests": len(reqs), "prompt_lengths": [len(r) for r in reqs],
           "max_new": args.max_new, "max_batch": args.max_batch,
           "max_seq": args.max_seq, "init_s": init_s, "wall_s": wall,
           "generated_tokens": st.generated_tokens,
           "tokens_per_s": st.generated_tokens / wall,
           "waves": st.waves, "prefill_tokens": st.prefill_tokens,
           "decode_steps": st.decode_steps, "prefill_ms": prefill_ms,
           "decode_ms_median": float(np.median(decode_ms)),
           "decode_ms_mean": float(np.mean(decode_ms)),
           "flash_attention_launches": launches,
           "layers_x_waves": cfg.num_layers * st.waves,
           "logits_finite": all(finite), "outputs_well_formed": shapes_ok,
           "peak_bytes": peak, "peak_share": peak / card,
           "card_bytes": card,
           "host_cpu": _host_cpu(), "first_output": outs[0][:8]}
    emit(out)
    if launches != cfg.num_layers * st.waves or launches == 0:
        raise SystemExit(f"serve: {launches} flash_attention launches for "
                         f"{st.waves} waves of {cfg.num_layers} layers")
    if not (all(finite) and shapes_ok):
        raise SystemExit("serve: non-finite logits or malformed outputs")
    return out, eng, reqs


def _counting_drops(prefill, dropped):
    """``prefill`` with `models.moe`'s drop count on (into ``dropped``)
    for the length of each call."""
    from repro_torch.models import moe

    def counted(*args, **kwargs):
        moe.dropped = dropped
        try:
            return prefill(*args, **kwargs)
        finally:
            moe.dropped = None
    return counted


def _device_top(prof, wall_s: float, n: int = 12) -> dict:
    """Device time by kernel name from a profile, and its busy share."""
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        kernels.append({"kernel": ev.key[:90], "ms": ms, "calls": ev.count})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(k["ms"] for k in kernels)
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "busy_share": device_ms / (wall_s * 1e3), "top": kernels[:n]}


def phase_serve_profile(eng, reqs) -> dict:
    """Device time by kernel and the idle share of one wave of the
    full-width server, under `torch.profiler`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    wave = [r for r in reqs if len(r) == len(reqs[0])][:eng.max_batch]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(wave, max_new=32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    top = _device_top(prof, wall)
    flash = [ev for ev in prof.key_averages() if "flash_fwd" in ev.key]
    out = {"phase": "serve_profile", "arch": eng.model.cfg.name,
           "wave_rows": len(wave), "prompt_len": len(wave[0]),
           "max_new": 32, **top, "idle_share": 1 - top["busy_share"],
           "flash_attention_device_ms": sum(
               getattr(ev, "self_device_time_total", 0) for ev in flash)
           / 1e3,
           "flash_attention_calls": sum(ev.count for ev in flash)}
    emit(out)
    if not top["top"]:
        raise SystemExit("the profiler saw no device time")
    return out


# the other architectures served at full width in bf16 from seed 0 (arch,
# layers kept or None for full depth, traffic): minicpm3-4b at full depth
# (4,263,336,448 parameters, 8.5 GB) through the serving launcher;
# qwen1.5-110b cut to 8 of 80 layers (111.2e9 parameters, 222 GB, do not
# fit: 8 layers are 13,388,439,552, 26.8 GB) and llava-next-34b cut to 20
# of 60 (68.8 GB before its cache; 20 layers are 12,096,666,624, 24.2 GB);
# the MoEs: deepseek-v2-lite at full depth (27 layers, 16,210,324,992
# parameters, 32.4 GB) through the launcher, llama4-scout cut to 8 of 48
# layers (107.8e9 parameters, 215.6 GB; 8 layers are 19,692,999,680, 39.4
# GB)
# (minicpm3-4b cut from 62 to 31 layers for the script's time limit:
# PERF.md section 7's second cut; the SSMs at full depth); the
# encoder-decoder seamless-m4t-large-v2 at full depth (24 + 24 layers,
# 2,038,556,672 parameters, 4.08 GB) through the launcher, each wave over
# its stub frames (4,096 a row)
ZOO = (("minicpm3_4b", 31, "requests"), ("qwen1p5_110b", 8, "requests"),
       ("llava_next_34b", 20, "vlm_wave"),
       ("deepseek_v2_lite_16b", None, "launcher"),
       ("llama4_scout_17b_16e", 8, "requests"),
       ("mamba2_780m", None, "launcher"), ("zamba2_7b", None, "launcher"),
       ("seamless_m4t_large_v2", None, "launcher"))
ZOO_TRAFFIC = dict(requests=4, max_new=16, vlm_rows=4, vlm_text=48)


def _expected_launches(cfg, stats) -> int:
    """``flash_attention`` launches of a serve: a decoder LM's attention
    layers a prefill wave (its decode is plain PyTorch); an
    encoder-decoder's `encdec.prefill_launches` a wave and its
    cross-attention's `encdec.decode_launches` a decode step."""
    from repro_torch.models import encdec
    from repro_torch.models.lm import attention_layers
    if cfg.is_encoder_decoder:
        return (encdec.prefill_launches(cfg) * stats.waves
                + encdec.decode_launches(cfg) * stats.decode_steps)
    return attention_layers(cfg) * stats.waves


def phase_serve_zoo() -> dict:
    """minicpm3-4b, qwen1.5-110b, llava-next-34b, deepseek-v2-lite,
    llama4-scout, mamba2-780m, zamba2-7b and seamless-m4t-large-v2 served
    on the card (`ZOO`), each model freed before the next; one line each,
    with the ``flash_attention`` count set to 0 just before each model
    serves and read just after (it must be `_expected_launches`: zamba2's
    27 ssm_attn layers a wave, none of mamba2's; seamless's 72 a wave
    and 24 a decode step), and an MoE's assignments dropped for capacity
    in its prefills."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as launcher
    from repro_torch.models import Model
    from repro_torch.models.lm import attention_layers
    from repro_torch.serve import ServeEngine
    tr, bf16 = ZOO_TRAFFIC, torch.bfloat16
    lines = {}
    for arch, layers, traffic in ZOO:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        extra = None
        if traffic == "launcher":
            args = launcher.build_parser().parse_args([
                "--arch", arch, "--device", DEVICE, "--requests",
                str(tr["requests"]), "--max-new", str(tr["max_new"])])
            eng = launcher.make_engine(args)
            cfg = eng.model.cfg
            reqs = launcher.make_requests(cfg, args.requests)
        else:
            cfg = get_config(arch).scaled(num_layers=layers)
            model = Model(cfg).init(0, bf16, DEVICE)
            if traffic == "requests":
                eng = ServeEngine(model, max_batch=8, max_seq=256, dtype=bf16)
                reqs = launcher.make_requests(cfg, tr["requests"])
            else:  # one vlm wave: patches ahead of the text tokens
                rng = np.random.default_rng(0)
                reqs = [rng.integers(1, cfg.vocab_size, tr["vlm_text"])
                        .tolist() for _ in range(tr["vlm_rows"])]
                eng = ServeEngine(model, max_batch=tr["vlm_rows"],
                                  max_seq=cfg.num_patch_tokens
                                  + tr["vlm_text"] + tr["max_new"],
                                  dtype=bf16)
                extra = {"patch_embeds": launcher.patch_embeds(
                    cfg, tr["vlm_rows"], bf16, DEVICE)}
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model = eng.model
        prefill_ms, decode_ms, finite = [], [], []
        dropped = torch.zeros((), dtype=torch.int64, device=DEVICE)
        model.prefill = _timed_host(_counting_drops(model.prefill, dropped),
                                    prefill_ms, finite)
        model.decode_step = _timed_host(model.decode_step, decode_ms, finite)
        try:
            flash_attention.launches = 0
            t0 = time.perf_counter()
            if traffic == "launcher":  # its waves' stub inputs, if any
                outs, _ = launcher.run_serve(args, eng, reqs)
            else:
                outs = eng.serve(reqs, max_new=tr["max_new"], extra=extra)
            wall = time.perf_counter() - t0
            launches = flash_attention.launches
        finally:
            del model.prefill, model.decode_step
        peak = torch.cuda.max_memory_allocated()
        card = torch.cuda.get_device_properties(0).total_memory
        st = eng.stats
        want = _expected_launches(cfg, st)
        shapes_ok = (len(outs) == len(reqs)
                     and all(len(o) == tr["max_new"] for o in outs)
                     and all(0 <= t < cfg.padded_vocab
                             for o in outs for t in o))
        out = {"phase": "serve_zoo", "arch": cfg.name, "dtype": "bfloat16",
               "layers": cfg.num_layers, "params": model.num_params(),
               "traffic": traffic, "requests": len(reqs),
               "prompt_lengths": [len(r) for r in reqs],
               "patch_tokens": (cfg.num_patch_tokens if extra is not None
                                else 0),
               "frames": cfg.source_len if cfg.is_encoder_decoder else 0,
               "max_new": tr["max_new"], "init_s": init_s, "wall_s": wall,
               "generated_tokens": st.generated_tokens,
               "tokens_per_s": st.generated_tokens / wall,
               "waves": st.waves, "prefill_tokens": st.prefill_tokens,
               "prefill_ms": prefill_ms,
               "decode_ms_median": float(np.median(decode_ms)),
               "flash_attention_launches": launches,
               "attention_layers": attention_layers(cfg),
               "layers_x_waves": want,
               "logits_finite": all(finite),
               "outputs_well_formed": shapes_ok, "peak_bytes": peak,
               "peak_share": peak / card, "first_output": outs[0][:8]}
        if cfg.num_experts:
            # decode cannot drop: a step's rows x top_k assignments (at
            # most 8 x 6) stay under an expert's 128 slots
            out.update(experts=cfg.num_experts, top_k=cfg.moe_top_k,
                       moe_dropped_in_prefills=int(dropped),
                       prefill_assignments=(st.prefill_tokens * cfg.moe_top_k
                                            * cfg.num_layers))
        emit(out)
        lines[arch] = out
        del eng, model, outs, extra
        if launches != want:
            raise SystemExit(f"serve_zoo {arch}: {launches} flash_attention "
                             f"launches where {st.waves} waves and "
                             f"{st.decode_steps} decode steps make {want}")
        if not (all(finite) and shapes_ok):
            raise SystemExit(f"serve_zoo {arch}: non-finite logits or "
                             f"malformed outputs")
    torch.cuda.empty_cache()
    return lines


# the backward's cases, those of `tests/test_torch_kernels_gpu.py`: the
# reference's gradient test, causal on and off, window, softcap, GQA groups
# 1, 2, 4 and 8, right-aligned and shifted queries, rows with no key, and
# gemma2's heads at 1,000 tokens with a window of 512 (the bf16 kernel's
# rings turn many times over full and edge tiles)
BWD_CASES = [  # b, hq, hkv, sq, skv, d, causal, window, softcap, q_offset
    (2, 4, 2, 64, 64, 16, True, 16, 25.0, 0),
    (1, 2, 2, 48, 48, 32, False, None, None, 0),
    (1, 4, 2, 48, 48, 32, True, None, None, 0),
    (1, 4, 4, 40, 64, 64, True, 8, None, 24),
    (2, 4, 2, 40, 40, 64, True, None, 30.0, 7),
    (1, 4, 1, 33, 33, 128, True, 4, 50.0, -5),
    (1, 2, 1, 16, 16, 16, True, 0, None, 0),
    (1, 4, 2, 100, 100, 256, False, None, 50.0, 0),
    (1, 16, 8, 200, 200, 256, True, 64, 50.0, 0),
    (1, 8, 1, 70, 70, 64, True, None, None, 0),
    (1, 16, 8, 1000, 1000, 256, True, 512, 50.0, 0),
    # softcaps that the logits reach (s ~ N(0, 1)): at 25 or 50, |s / cap|
    # stays under 0.2 and the capped rule is within 1e-3 of the uncapped
    (2, 4, 2, 64, 64, 16, True, 16, 2.0, 0),
    (2, 4, 2, 100, 100, 128, False, None, 1.0, 0),
    (1, 8, 1, 70, 70, 64, True, None, 3.0, 0),
    (1, 16, 8, 200, 200, 256, True, 64, 2.0, 0),
]
# the MLA pairs' and zamba2's (112, 112) backward cases: causal and not,
# GQA, window, softcaps that the logits reach, shifted queries with rows
# that see no key; then the pair's dv as an 11th field
MLA_BWD_CASES = [c + (pair[1],) for pair in PAIRS for c in (
    (1, 4, 4, 100, 100, pair[0], True, None, None, 0),
    (2, 4, 4, 64, 64, pair[0], False, None, None, 0),
    (1, 8, 2, 70, 70, pair[0], True, None, 2.0, 0),
    (1, 4, 1, 40, 64, pair[0], True, 16, None, 24),
    (2, 4, 2, 33, 33, pair[0], False, 8, 3.0, -5))]
# the MLA models' train attention (minicpm3-4b's and deepseek-v2-lite's
# heads) at train_4k's 4096 tokens
MLA_TRAIN_TOKENS = 4096
# gemma2-9b's train attention: one sequence of train_4k's 4096 tokens, bf16
GEMMA_TRAIN_ATTN = dict(b=1, hq=16, hkv=8, s=4096, d=256, softcap=50.0,
                        window=4096)
# the full-width train cell: gemma2-9b cut from 42 to 20 layers (12 bytes a
# parameter: bf16 weight and gradient, f32 m and v: 58.6 GB at 20 layers,
# 111 GB at 42), the launcher's seq 4096, batch 1
TRAIN = dict(layers=20, seq=4096, batch=1, steps=5)


def phase_attention_bwd() -> dict:
    """flash_attention_bwd on the card against `_bwd_rule`'s port on the
    card (each dtype through its route: bf16 the wgmma kernel, f32 the
    3xTF32 kernel), both forward kernels' lse against `_fwd_impl`'s,
    then gemma2's train shape timed beside its bound and the SDPA
    yardstick, and the f32 routes timed at the train-parity shape (where
    they launch) and at gemma2's train shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels.ref import attention_mask
    dev = torch.device(DEVICE)
    called, call = [], tfa._call

    def record(route, *args):  # the library each wrapper call reaches
        called.append(route)
        return call(route, *args)
    tfa._call = record

    def inputs(b, hq, hkv, sq, skv, d, dtype, seed, dv=None):
        # q, k of head_dim d; v, dO of dv (MLA), default d
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(b, h, s, w, generator=gen, device=dev).to(dtype)
                for h, s, w in ((hq, sq, d), (hkv, skv, d), (hkv, skv, dv or d),
                                (hq, sq, dv or d))]

    def check(case, dtype):
        b, hq, hkv, sq, skv, d, causal, window, softcap, off = case[:10]
        dv = case[10] if len(case) > 10 else d
        dt = getattr(torch, dtype)
        q, k, v, do = inputs(b, hq, hkv, sq, skv, d, dt, sq + d, dv)
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=off)
        o, lse = tfa.flash_attention_fwd_plain(q, k, v, **kw)
        launches = tfa.flash_attention_bwd.launches
        called.clear()
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        launched = tfa.flash_attention_bwd.launches - launches
        routes = list(called)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        o_k, lse_k = tfa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        errs = {n: float((g.float() - w.float()).abs().max())
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        scales = {n: float(w.float().abs().max())
                  for n, w in zip(("dq", "dk", "dv"), want)}
        big = lse == tfa.BIG
        lse_err = float((lse_k - lse).abs().masked_fill(big, 0.0).max())
        lse_scale = max(1.0, float(lse.masked_fill(big, 0.0).abs().max()))
        lse_tol = 1e-3 if dtype == "bfloat16" else 1e-4
        ok = (launched == 1 and routes == [tfa.bwd_kernel_route(dt, d, dv)]
              and all(errs[n] <= tol * max(scales[n], 1e-30) for n in errs)
              and torch.equal(lse_k == tfa.BIG, big)
              and lse_err <= lse_tol * lse_scale
              and torch.equal(o_k, tfa.flash_attention(q, k, v, **kw)))
        return {"case": dict(b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d, dv=dv,
                             causal=causal, window=window, softcap=softcap,
                             q_offset=off, dtype=dtype),
                "route": routes, "fwd_route": tfa.kernel_route(dt, d, dv),
                "max_abs_err": errs,
                "max_abs": scales, "tol_of_max": tol,
                "lse_max_abs_err": lse_err, "lse_tol": lse_tol * lse_scale,
                "empty_rows": int(big.sum()), "ok": ok}

    cases = [check(c, dt) for dt in ("float32", "bfloat16")
             for c in BWD_CASES + MLA_BWD_CASES]
    t0 = time.perf_counter()
    cases += [check(c, dt) for dt in ("float32", "bfloat16")
              for c in CROSS_BWD_CASES]
    cross_s = time.perf_counter() - t0

    def timed(dtype, shape, window, softcap, dv=None, sdpa_backends=None,
              skv=None, causal=True):
        # shape: (b, hq, hkv, s, d), s the queries; skv the keys (default
        # s); a non-causal call (seamless) may have s > skv
        b, hq, hkv, s, d = shape
        dv, skv = dv or d, skv or s
        q, k, v, do = inputs(b, hq, hkv, s, skv, d, getattr(torch, dtype),
                             7, dv)
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)

        def fn():
            return tfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        called.clear()
        got = fn()
        route = list(called)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        abs_errs = {n: float((a.float() - w.float()).abs().max())
                    for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        errs = {n: abs_errs[n] / max(float(w.float().abs().max()), 1e-30)
                for n, w in zip(("dq", "dk", "dv"), want)}
        del got, want
        # the forward's output against the plain version's
        fwd_err = float((o.float() - tfa.flash_attention_fwd_plain(
            q, k, v, **kw)[0].float()).abs().max())
        keep = attention_mask(s, skv, causal=causal, window=window,
                              device=dev)
        pairs = int(keep.sum())
        # the rule's five products (s, dq, dk over D; dp, dv over Dv),
        # 2 flops a visible pair a column each, on the peak of the dtype
        # (bf16 the tensor cores', f32 the tensor cores' in 3xTF32, with
        # the CUDA cores' beside it); bytes: q, k, v, o, dO and the
        # outputs once, lse once.  The forward: two products (QK^T over D,
        # PV over Dv), q, k, v read and o, lse written once
        size = q.element_size()
        flop_ms, cc_ms = _flop_bounds(tfa.bwd_flops(d, dv, pairs * b * hq),
                                      dtype)
        byte_ms = (size * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                           + 2 * o.numel() + do.numel())
                   + 4 * lse.numel()) / HBM_BYTES_PER_S * 1e3
        fwd_flop_ms, fwd_cc_ms = _flop_bounds(
            tfa.fwd_flops(d, dv, pairs * b * hq), dtype)
        fwd_byte_ms = (size * (q.numel() + k.numel() + v.numel()
                               + o.numel())
                       + 4 * lse.numel()) / HBM_BYTES_PER_S * 1e3
        # a call's device time: the mean event of each of its passes (the
        # profiler may see only some of the 20 calls' events)
        names = device_ms_by_name(fn)
        passes = {kind: x["ms"] for n, x in names.items()
                  for kind in ("bwd_delta", "bwd_dkdv", "bwd_dq") if kind in n}
        b2b = back_to_back_ms(fn)
        kernel_ms = sum(passes.values())
        source = "torch.profiler, the mean event of each pass seen"
        if not {"bwd_dkdv", "bwd_dq"} <= passes.keys():
            kernel_ms, source = b2b, "cuda events, 20 calls in a row"
        # the yardstick: SDPA's backward (fwd + bwd minus fwd), same causal
        # mask (the 4096 window masks nothing more at 4096 tokens), no
        # softcap (SDPA has none): the same function without the cap
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        gqa = dict(enable_gqa=True) if hq != hkv or dv == d else {}
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=causal, **gqa)
        sdpa_fwd_ms, library_note = _sdpa_ms(sdpa, sdpa_backends)
        sdpa_fb_ms = _sdpa_ms(lambda: sdpa().backward(do), sdpa_backends)[0]
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        row = {"case": dict(b=b, hq=hq, hkv=hkv, s=s, skv=skv, d=d, dv=dv,
                            causal=causal, window=window, softcap=softcap,
                            dtype=dtype),
               "route": route, "err_of_max": errs, "tol_of_max": tol,
               "max_abs_err": max(abs_errs.values()),
               "fwd_max_abs_err": fwd_err,
               "ok": (route == [tfa.bwd_kernel_route(q.dtype, d, dv)]
                      and max(errs.values()) <= tol
                      and (dtype != "float32" or fwd_err < 2e-5)),
               "pairs_per_head": pairs, "kernel_ms": kernel_ms,
               "kernel_ms_source": source, "device_ms_by_name": names,
               "ms": cuda_ms(fn, 10), "back_to_back_ms": b2b,
               "host_us": host_us(fn),
               "plain_ms": cuda_ms(lambda: tfa.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, **kw), 3),
               "fwd_ms": cuda_ms(lambda: tfa.flash_attention(
                   q, k, v, return_lse=True, **kw), 10),
               "fwd_plain_ms": cuda_ms(lambda: tfa.flash_attention_fwd_plain(
                   q, k, v, **kw), 3),
               "fwd_bound_ms": max(fwd_flop_ms, fwd_byte_ms),
               "fwd_bound_by": ("operations" if fwd_flop_ms >= fwd_byte_ms
                                else "bytes"),
               "fwd_cuda_core_bound_ms": None if fwd_cc_ms is None
               else max(fwd_cc_ms, fwd_byte_ms),
               "library_fwd_bwd_ms": sdpa_fb_ms,
               "library_fwd_ms": sdpa_fwd_ms,
               "library_ms": (sdpa_fb_ms - sdpa_fwd_ms
                              if sdpa_fb_ms is not None
                              and sdpa_fwd_ms is not None else None),
               "library_note": library_note,
               "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "cuda_core_bound_ms": None if cc_ms is None
               else max(cc_ms, byte_ms)}
        _shares(row, "kernel_ms")
        _shares(row, "fwd_ms", "fwd_")
        del q, k, v, do, o, lse, qs, ks, vs, keep
        torch.cuda.empty_cache()
        return row

    g = GEMMA_TRAIN_ATTN
    train = (g["b"], g["hq"], g["hkv"], g["s"], g["d"])
    parity = (2, PARITY_LM["num_heads"], PARITY_LM["num_kv_heads"], 128,
              PARITY_LM["head_dim"])  # train_parity's batch of 2 x 128
    timing = {"global": timed("bfloat16", train, None, g["softcap"]),
              "local": timed("bfloat16", train, g["window"], g["softcap"])}
    # the f32 routes (both forward and backward): where they launch on the
    # main path, train_parity's global layers, and at gemma2's train shape
    f32 = {"train_parity": timed("float32", parity, None, g["softcap"]),
           "gemma2_9b_train": timed("float32", train, None, g["softcap"])}
    # the MLA models' heads (minicpm3-4b's, deepseek-v2-lite's) at the
    # train shape, both dtypes
    def mla_train(m, backends=SDPA_DV_BACKENDS):
        shape = (m["b"], m["hq"], m["hkv"], MLA_TRAIN_TOKENS, m["d"])
        return {dtype: timed(dtype, shape, None, None, dv=m["dv"],
                             sdpa_backends=backends)
                for dtype in ("bfloat16", "float32")}
    mla = mla_train(MLA_ATTN)
    deepseek = mla_train(DEEPSEEK_ATTN)
    zamba = mla_train(ZAMBA_ATTN, None)  # zamba2's heads, (112, 112)
    # seamless-m4t's heads, non-causal: the encoder's self-attention and
    # the cross-attention of a decoder longer than the frames
    sm = SEAMLESS_ATTN
    t0 = time.perf_counter()
    seamless = {dtype: {
        "encoder": timed(dtype, (1, sm["h"], sm["h"], sm["frames"],
                                 sm["d"]), None, None, causal=False),
        "cross": timed(dtype, (1, sm["h"], sm["h"], sm["train_queries"],
                               sm["d"]), None, None, skv=sm["frames"],
                       causal=False)}
        for dtype in ("bfloat16", "float32")}
    seamless_s = time.perf_counter() - t0
    tfa._call = call
    routes = {"bfloat16": tfa.bwd_kernel_route(torch.bfloat16)
              + " (wgmma, TMA)",
              "float32": tfa.bwd_kernel_route(torch.float32)
              + " (3xTF32 on the tensor cores, mma.sync)"}
    print(f"flash_attention_bwd route: bf16 -> {routes['bfloat16']}, "
          f"f32 -> {routes['float32']}", flush=True)
    libs = ("flash_attention_bwd_sm90", "flash_attention_bwd",
            "flash_attention_bwd_sm90_mla", "flash_attention_bwd_mla")
    ptxas = {lib: [ln.strip() for ln in _build.ptxas_report(lib).splitlines()
                   if "Used" in ln or "spill" in ln or "Compiling" in ln
                   or "C75" in ln]
             for lib in libs}
    for lib, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas {lib}: {ln}", flush=True)
    sass = {lib: _sass_summary(lib) for lib in libs}
    for lib, kernels in sass.items():
        for kernel, counts in kernels.items():
            print(f"sass {lib} {kernel}: {json.dumps(counts)}", flush=True)
    bad = [c for c in cases + list(timing.values()) + list(f32.values())
           + list(mla.values()) + list(deepseek.values())
           + list(zamba.values())
           + [r for rows in seamless.values() for r in rows.values()]
           if not c["ok"]]
    out = {"phase": "attention_bwd", "kernel": "flash_attention_bwd",
           "replaces": "none: the JAX package differentiates in XLA "
                       "(src/repro/models/flash_xla.py:100, _bwd_rule)",
           "routes": routes,
           "library": "scaled_dot_product_attention fwd+bwd minus fwd "
                      "(is_causal, enable_gqa), without softcap",
           "cases": cases, "mismatches": bad,
           "max_abs_err": max(max(c["max_abs_err"].values())
                              for c in cases),
           "gemma2_9b_train": timing, "f32_routes": f32,
           "minicpm3_4b_train": mla, "deepseek_v2_lite_16b_train": deepseek,
           "zamba2_7b_train": zamba, "seamless_m4t_large_v2_train": seamless,
           "seconds": {"cross_cases": cross_s, "seamless": seamless_s},
           "ptxas": ptxas, "sass": sass}
    emit(out)
    if bad:
        raise SystemExit("flash_attention_bwd or an lse disagrees with its "
                         "plain version")
    return out


# the weight matrices of a parameter tree: linear layers' ``w``, an MoE
# block's router and stacked experts ([G, E, d_in, d_out]), and an SSM
# block's projections
WEIGHT_KEYS = ("w", "router", "w_gate", "w_up", "w_down", "in_proj",
               "out_proj")


def _trained_scale(params) -> None:
    """Each weight matrix (`WEIGHT_KEYS`: stacked [G, ..., d_in, d_out] or
    [d_in, d_out]) rescaled in place from the init's std 1/sqrt(shape[0])
    to 1/sqrt(d_in), as a trained model keeps its activations O(1)."""
    import torch

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in WEIGHT_KEYS:
                with torch.no_grad():
                    val.mul_((val.shape[0] / val.shape[-2]) ** 0.5)
    walk(params)


def _leaf_errors(got, want) -> dict:
    """{path: max |got - want| / max |want|} over two gradient trees."""
    out = {}

    def walk(g, w, prefix):
        for key in sorted(w):
            if isinstance(w[key], dict):
                walk(g[key], w[key], f"{prefix}{key}/")
            else:
                a = g[key].detach().cpu().double()
                b = w[key].detach().double()
                out[prefix + key] = float(
                    (a - b).abs().max() / max(float(b.abs().max()), 1e-300))
    walk(got, want, "")
    return out


def _grads(model, batch):
    import torch
    from repro_torch.models.params import tree_leaves, tree_map
    loss = model.loss_fn(model.params, batch)
    it = iter(torch.autograd.grad(loss, tree_leaves(model.params)))
    return float(loss.detach()), tree_map(lambda _: next(it), model.params)


def _f32_entry(rows: dict, prefix: str) -> dict:
    """The kernels line's numbers of an f32 kernel (``prefix`` "fwd_" the
    forward, "" the backward) from `phase_attention_bwd`'s ``f32_routes``:
    at the train-parity shape, with gemma2's train shape beside."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "cuda_core_bound_ms", "share_of_bound",
            "share_of_cuda_core_bound")
    library = "library_fwd_ms" if prefix else "library_ms"

    def pick(row):
        out = {k: row[prefix + k] for k in keys}
        out["library_ms"] = row[library]
        if not prefix:
            out["kernel_ms"] = row["kernel_ms"]
        return out
    return {**pick(rows["train_parity"]),
            "shape": rows["train_parity"]["case"],
            "gemma2_9b_train": pick(rows["gemma2_9b_train"])}


def phase_train_parity() -> dict:
    """A 4-layer gemma2 (d_model 512) in f32 trained on the card and on
    the CPU from one init: first-step gradients against the CPU's float64
    evaluation, the kernels' launches a step against the remat's count,
    3 steps' losses, and a checkpointed run killed at step 2 and
    restored."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models import Model
    from repro_torch.models.lm import _sqrt_split, remat_forwards
    from repro_torch.models.params import tree_map
    from repro_torch.optim import OptConfig
    from repro_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    t0 = time.perf_counter()
    cfg = get_config("gemma2_9b").scaled(**PARITY_LM)
    init = Model(cfg).init(0, torch.float32, DEVICE).params
    _trained_scale(init)
    host = tree_map(lambda t: t.detach().cpu(), init)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, 2, 128, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    card = Model(cfg).load(tree_map(lambda t: t.detach().clone(), init),
                           trainable=True)
    cpu = Model(cfg).load(tree_map(torch.clone, host), trainable=True)
    cpu64 = Model(cfg).load(tree_map(lambda t: t.double(), host),
                            trainable=True)
    tfa.flash_attention.launches = tfa.flash_attention_bwd.launches = 0
    loss_card, g_card = _grads(card, {k: v.to(DEVICE)
                                      for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {"fwd": tfa.flash_attention.launches,
                "bwd": tfa.flash_attention_bwd.launches}
    loss_cpu, g_cpu = _grads(cpu, batch)
    loss64, g64 = _grads(cpu64, batch)
    expect = {"fwd": remat_forwards(cfg), "bwd": cfg.num_layers}
    err_card, err_cpu = _leaf_errors(g_card, g64), _leaf_errors(g_cpu, g64)
    del g_card, g_cpu, g64, card, cpu, cpu64
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=40)

    def trainer(device, params, ckpt=None):
        return Trainer(Model(cfg), opt, pipe, ckpt=ckpt, device=device,
                       params=tree_map(lambda t: t.detach().clone().to(
                           device), params))
    steps = 3
    card_losses = trainer(DEVICE, init).run(steps).losses
    cpu_losses = trainer("cpu", host).run(steps).losses
    # a checkpointed card run: a step fails at step 2 (the trainer
    # restores its step-2 checkpoint and goes on), and a new trainer on
    # the same directory (a killed process's successor) restores and
    # finishes
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        fired = []

        def kill_at_2(step):
            if step == 2 and not fired:
                fired.append(step)
                raise RuntimeError("killed at step 2")
        tr = trainer(DEVICE, init, CheckpointManager(d, keep=2))
        res = tr.run(steps, ckpt_every=1, fault_injector=kill_at_2)
        fault_losses, restarts = res.losses, res.restarts
        del tr
        # the directory as a process killed during step 2 leaves it
        shutil.rmtree(Path(d) / f"step_{steps:08d}")
        tr2 = trainer(DEVICE, init, CheckpointManager(d, keep=2))
        restored_from = tr2.step
        resumed = tr2.run(steps - tr2.step).losses
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    out = {"phase": "train_parity", "config": PARITY_LM, "dtype": "float32",
           "batch": 2, "seq": 128, "init": "Model.init(0), weight matrices "
           "at std 1/sqrt(d_in)",
           "loss": {"card": loss_card, "cpu": loss_cpu, "f64": loss64},
           "grad_err_of_max_card_vs_f64": err_card,
           "grad_err_of_max_cpu_vs_f64": err_cpu,
           "remat_split": _sqrt_split(cfg.pattern_groups),
           "launches_a_step": launches, "launches_expected": expect,
           "card_losses": card_losses, "cpu_losses": cpu_losses,
           "fault_losses": fault_losses, "fault_restarts": restarts,
           "restored_from_step": restored_from, "resumed_losses": resumed,
           "seconds": time.perf_counter() - t0}
    emit(out)
    print(f"train_parity: flash_attention {launches['fwd']} forward and "
          f"{launches['bwd']} backward launches a step; the remat "
          f"{_sqrt_split(cfg.pattern_groups)} gives {expect['fwd']} and "
          f"{expect['bwd']}", flush=True)
    ok = (max(err_card.values()) <= 1e-4 and launches == expect
          and rel(loss_card, loss64) <= 1e-4
          and all(rel(a, b) <= 1e-4
                  for a, b in zip(card_losses, cpu_losses))
          and restarts == 1 and len(fault_losses) == steps
          and all(rel(a, b) <= 1e-6 for a, b in zip(fault_losses,
                                                     card_losses))
          and restored_from == steps - 1
          and rel(resumed[0], card_losses[-1]) <= 1e-6)
    if not ok:
        raise SystemExit("train_parity: the card's training differs")
    return out


def phase_train() -> dict:
    """gemma2-9b at full width, 20 of its 42 layers, bf16 with f32 AdamW
    state: the train launcher's `make_trainer` at seq 4096, batch 1, for
    `TRAIN` steps, with the kernel counts set to 0 just before and read
    just after; then one more step under `torch.profiler`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch import train as launcher
    from repro_torch.models.lm import _sqrt_split, remat_forwards
    cfg = get_config("gemma2_9b").scaled(num_layers=TRAIN["layers"])
    args = launcher.build_parser().parse_args(
        ["--arch", "gemma2_9b", "--seq", str(TRAIN["seq"]), "--batch",
         str(TRAIN["batch"]), "--steps", str(TRAIN["steps"]),
         "--device", DEVICE])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = launcher.make_trainer(cfg, args, ckpt=False)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []
    step_fn = trainer.step_fn

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        loss = float(out[2]["loss"])
        seconds = time.perf_counter() - t
        tokens = batch["tokens"].numel()
        line = {"step": len(steps), "loss": loss, "step_ms": seconds * 1e3,
                "tokens_per_s": tokens / seconds,
                "grad_norm": float(out[2]["grad_norm"]),
                "lr": out[2]["lr"]}
        steps.append(line)
        print(f"train step {line['step']}: {json.dumps(line)}", flush=True)
        return out
    trainer.step_fn = timed_step
    tfa.flash_attention.launches = tfa.flash_attention_bwd.launches = 0
    res = trainer.run(TRAIN["steps"])
    launches = {"fwd": tfa.flash_attention.launches,
                "bwd": tfa.flash_attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    expect = {"fwd": remat_forwards(cfg) * TRAIN["steps"],
              "bwd": cfg.num_layers * TRAIN["steps"]}
    print(f"done: steps={res.steps_done} restarts={res.restarts} "
          f"loss={res.losses[0]:.3f}->{res.losses[-1]:.3f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    top = _device_top(prof, wall, n=16)
    by = lambda key: sum(  # noqa: E731
        getattr(ev, "self_device_time_total", 0) for ev in
        prof.key_averages() if key in ev.key) / 1e3
    counted = _counted_step(trainer, step_fn, cfg, float(np.median(
        [x["step_ms"] for x in steps[1:-1]])) / 1e3)
    out = {"phase": "train", "arch": cfg.name, "source": "arXiv:2408.00118",
           "layers": cfg.num_layers, "reduced": "depth 42 -> 20 layers "
           "(the card: 12 bytes a parameter)", "params": trainer.model
           .num_params(), "dtype": "bfloat16", "opt_state": "float32",
           "seq": TRAIN["seq"], "batch": TRAIN["batch"],
           "remat_split": _sqrt_split(cfg.pattern_groups), "init_s": init_s,
           "steps": steps[:-1], "losses": res.losses,
           "step_ms_median": float(np.median(
               [x["step_ms"] for x in steps[1:-1]])),
           "tokens_per_s_median": float(np.median(
               [x["tokens_per_s"] for x in steps[1:-1]])),
           "median_over": "steps 1.. (step 0 warms up)",
           "profiled_step": steps[-1],
           "launches": launches, "launches_expected": expect,
           "peak_bytes": peak, "peak_share": peak / card,
           "card_bytes": card,
           "profile": {**top, "idle_share": 1 - top["busy_share"],
                       "flash_fwd_device_ms": by("flash_fwd"),
                       "flash_bwd_device_ms": by("bwd_"),
                       "host_cpu": _host_cpu()},
           "counted_step": counted}
    emit(out)
    print(f"train: one step counted by launch.hlo_stats: "
          f"{counted['counted_flops']:.4e} FLOPs, model FLOPs 6*N*T "
          f"{counted['model_flops']:.4e}, useful_flops_ratio "
          f"{counted['useful_flops_ratio']:.4f}; the median step "
          f"{counted['median_step_s'] * 1e3:.1f} ms reaches "
          f"{counted['roofline_fraction']:.4f} of the H100's bf16 peak",
          flush=True)
    if launches != expect:
        raise SystemExit(f"train: flash_attention launches {launches}, "
                         f"the remat gives {expect}")
    if not (all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                for x in steps) and len(steps) == TRAIN["steps"] + 1
            and res.steps_done == TRAIN["steps"] and not res.restarts):
        raise SystemExit("train: a step failed or a loss is not finite")
    if not top["top"]:
        raise SystemExit("the profiler saw no device time")
    del trainer
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ the mesh
# the sharded step: gemma2's smoke config in f32 over a 4x2 (data, model)
# mesh of 8 gloo ranks sharing the card, against the one-rank step
SHARDED = dict(ranks=8, mesh=(4, 2), batch=8, seq=32, seed=0, tol=1e-4)
# the MoE's all-to-all dispatch on the same 8 ranks: the reference test's
# layer (`tests/test_distributed.py::test_moe_a2a_matches_dense_dispatch`:
# 4 experts, top-2, capacity factor 8) over a (2, 2, 2) pod x data x model
# mesh against the dense dispatch, x [8, 8, 16]: values within 2e-4,
# gradients within 2e-3, the reference's bar
MOE_A2A = dict(mesh=(2, 2, 2), x=(8, 8, 16), tol=2e-4, grad_tol=2e-3,
               layer=dict(name="t", family="moe", num_layers=1, d_model=16,
                          num_heads=2, num_kv_heads=2, d_ff=24,
                          vocab_size=32, num_experts=4, moe_top_k=2,
                          capacity_factor=8.0))
SHARDED_DIR = ROOT / "build" / "sharded-smoke"  # rank logs; removed at exit
# the dry-run's cells on the single-pod mesh (host work: a worker process
# beside the card phases), their JSON under DRYRUN_DIR (removed at exit)
DRYRUN_CELLS = (("--arch", "gemma2_9b", "--shape", "train_4k"),
                ("--arch", "gemma2_9b", "--shape", "decode_32k"),
                ("--arch", "mamba2_780m", "--shape", "long_500k"),
                ("--arch", "zamba2_7b", "--shape", "long_500k"),
                ("--arch", "bisim", "--bisim-mode", "sorted",
                 "--bisim-ranking", "allgather"),
                ("--arch", "bisim", "--bisim-mode", "sorted",
                 "--bisim-ranking", "bucketed"))
DRYRUN_DIR = ROOT / "build" / "dryrun-smoke"
# the wrappers' host time a call before they became ops (an H100 80GB
# HBM3 at 700 W; PERF.md's kernel table)
HOST_US_BEFORE_OPS = {"sig_fold": 37, "frontier_sig_fold": 25,
                "flash_attention": 86, "flash_attention_bwd": 190}


def dispatch_us() -> dict:
    """The op's share of each wrapper's host time: host µs a call (200
    calls, the best of five rounds, the three forms alternated) through
    the ``repro_torch`` op (``op_us``), through a
    `torch.library.custom_op` of the same schema around the same function
    (``custom_op_us``: the form the ops had before, defined here for the
    comparison), and with the kernel call made directly (``direct_us``:
    the function the op's CUDA kernel runs), on small inputs so that the
    host sets the pace.  Launch counts are put back afterwards."""
    import torch
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import sig_fold as tsf
    counts = (tsf.sig_fold.launches, tfa.flash_attention.launches,
              tfa.flash_attention_bwd.launches)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    n, nb = 4096, 256
    lanes = [torch.randint(0, 50, (n,), generator=g, device=DEVICE,
                           dtype=torch.int32) for _ in range(2)]
    lanes += [torch.sort(torch.randint(0, nb, (n,), generator=g,
                                       device=DEVICE,
                                       dtype=torch.int32)).values,
              torch.ones(n, dtype=torch.bool, device=DEVICE)]
    q = torch.randn(1, 4, 128, 64, generator=g, device=DEVICE,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(1, 2, 128, 64, generator=g, device=DEVICE,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(o)
    fwd_kw = dict(causal=True, window=None, softcap=None, scale=None,
                  block_q=128, block_k=128, q_offset=None, return_lse=True)
    bwd_kw = dict(causal=True, window=None, softcap=None, scale=None,
                  q_offset=None)
    pairs = {
        "sig_fold": (
            lambda: torch.ops.repro_torch.sig_fold(*lanes, nb, n, True,
                                                   True),
            lambda: tsf._fold_on_card(*lanes, nb, n, True, True)),
        "flash_attention": (
            lambda: torch.ops.repro_torch.flash_attention(
                q, k, v, *fwd_kw.values()),
            lambda: tfa._fwd_on_card(q, k, v, **fwd_kw)),
        "flash_attention_bwd": (
            lambda: torch.ops.repro_torch.flash_attention_bwd(
                q, k, v, o, lse, do, *bwd_kw.values()),
            lambda: tfa._bwd_on_card(q, k, v, o, lse, do, **bwd_kw))}
    direct_fns = {"sig_fold": tsf._fold_on_card,
                  "flash_attention": tfa._fwd_on_card,
                  "flash_attention_bwd": tfa._bwd_on_card}
    out = {}
    for name, (op, direct) in pairs.items():
        schema = str(getattr(torch.ops.repro_torch, name).default._schema)
        custom = torch.library.custom_op(
            f"chip_smoke::{name}", direct_fns[name], mutates_args=(),
            schema=schema[schema.index("("):])
        args = {"sig_fold": (*lanes, nb, n, True, True),
                "flash_attention": (q, k, v, *fwd_kw.values()),
                "flash_attention_bwd": (q, k, v, o, lse, do,
                                        *bwd_kw.values())}[name]
        forms = {"op_us": op, "custom_op_us": lambda: custom(*args),
                 "direct_us": direct}
        rounds = [{key: host_us(fn, 200) for key, fn in forms.items()}
                  for _ in range(5)]
        out[name] = {key: min(r[key] for r in rounds) for key in forms}
    (tsf.sig_fold.launches, tfa.flash_attention.launches,
     tfa.flash_attention_bwd.launches) = counts
    return out


def _flat_tree(tree, prefix="") -> dict:
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat_tree(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = tree[key]
    return out


def _placement_names(placements) -> list:
    from torch.distributed.tensor import Replicate, Shard
    return [f"S{p.dim}" if isinstance(p, Shard) else
            "R" if isinstance(p, Replicate) else "P" for p in placements]


_REDUCE_OPS = {"sum": "SUM", "avg": "AVG", "max": "MAX", "min": "MIN",
               "product": "PRODUCT"}


def staged_collectives(mesh, devices=("cuda",)):
    """A context in which DTensor's functional collectives
    (``_c10d_functional``) on ``mesh``'s gloo groups run as the c10d
    collectives, which complete before they return; a null context when
    the default group is not gloo or the mesh lives off ``devices``.

    Why: gloo takes CUDA tensors in the c10d collectives (it stages them
    through host memory itself), but torch 2.11's gloo crashes (SIGSEGV)
    in ``wait_tensor`` on the functional ops' CUDA work, and NCCL refuses
    two ranks on one card.  So the harness's 8 ranks sharing one card
    enter this around the step; a deployment (NCCL, a card a rank) does
    not.  The tensors stay where they are; nothing else changes."""
    import torch
    import torch.distributed as dist
    if (mesh is None or mesh.device_type not in devices
            or not dist.is_initialized() or dist.get_backend() != "gloo"):
        return contextlib.nullcontext()
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    def reduce_op(name):
        return getattr(dist.ReduceOp, _REDUCE_OPS[name])

    class StagedCollectives(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace != "_c10d_functional" or not (
                    isinstance(args[0], torch.Tensor)
                    and args[0].device.type in devices):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # its local ops come back here
                return func(*args, **kwargs)
            name = func._opname
            if name == "wait_tensor":
                return args[0]  # the collective has completed
            names = [a.name for a in func._schema.arguments]
            if "group_name" not in names:  # not a collective
                return func(*args, **kwargs)
            args = list(args) + [kwargs[n] for n in names[len(args):]
                                 if n in kwargs]
            pg = _resolve_process_group(args[names.index("group_name")])
            if dist.get_backend(pg) != "gloo":
                return func(*args, **kwargs)
            x = args[0].contiguous()
            if name == "all_gather_into_tensor":
                out = x.new_empty((args[1] * x.shape[0], *x.shape[1:]))
                dist.all_gather_into_tensor(out, x, group=pg)
            elif name == "reduce_scatter_tensor":
                out = x.new_empty((x.shape[0] // args[2], *x.shape[1:]))
                dist.reduce_scatter_tensor(out, x, op=reduce_op(args[1]),
                                           group=pg)
            elif name == "all_reduce":
                out = x.clone()
                dist.all_reduce(out, op=reduce_op(args[1]), group=pg)
            elif name == "all_to_all_single":
                out_sizes, in_sizes = list(args[1]), list(args[2])
                out = x.new_empty((sum(out_sizes) if out_sizes
                                   else x.shape[0], *x.shape[1:]))
                dist.all_to_all_single(out, x, out_sizes or None,
                                       in_sizes or None, group=pg)
            elif name == "broadcast":
                out = x.clone()
                dist.broadcast(out, dist.get_global_rank(pg, args[1]),
                               group=pg)
            else:
                raise NotImplementedError(
                    f"{func}: no staged form on a gloo group")
            return out

    return StagedCollectives()


def sharded_train_worker(out_dir: str) -> int:
    """One rank of ``sharded_train_parity`` (torchrun's variables in its
    environment; gloo, the card shared): rank 0 first takes the one-rank
    step on the card; then every rank takes the sharded step over the 4x2
    mesh with the attention kernels' counts set to 0 just before and read
    just after, recording the heads the kernels get, the gradients AdamW
    gets and their placements beside their weights'; then the same step
    over a 2x4 mesh (2 kv heads over a 4-way model axis: one kv head a
    rank, dk/dv a Partial sum).  Rank 0 compares every gradient (to its
    leaf's max |g|), the grad norm, the loss and every leaf with the
    one-rank step's.  Both sharded steps run inside `staged_collectives`.
    Writes ``rank{r}.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.cluster import init_cluster
    from repro_torch.models import Model, flash_xla
    from repro_torch.models.lm import remat_forwards
    from repro_torch.models.params import tree_map
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import trainer as trainer_mod
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    rank, world = init_cluster(device=DEVICE, backend="gloo")
    cfg = get_smoke_config("gemma2_9b")
    init = Model(cfg).init(SHARDED["seed"], torch.float32, DEVICE).params
    _trained_scale(init)
    rng = np.random.default_rng(SHARDED["seed"])
    shape = (SHARDED["batch"], SHARDED["seq"])
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
             .to(DEVICE) for k in ("tokens", "labels")}
    opt = OptConfig()
    rules = meshlib.DEFAULT_RULES
    info = {"rank": rank, "world": world}
    apply, pin = flash_xla.FlashAttention.apply, trainer_mod.pin

    def step_once(mesh, heads: set):
        """One step from ``init`` (over ``mesh`` if given): (new leaves,
        metrics, the gradients AdamW got, their placements beside the
        weights'), leaves and gradients gathered whole on every rank."""
        model = Model(cfg)
        params = tree_map(lambda t: t.detach().clone(), init)
        grads, placed = [], []

        def seen_apply(q, k, v, *rest):
            heads.add((q.shape[2], k.shape[2], type(q).__name__,
                       q.device.type, str(q.dtype)))
            return apply(q, k, v, *rest)

        def seen_pin(grad, weight):
            out = pin(grad, weight)
            grads.append(out)
            if mesh is not None:
                placed.append((_placement_names(out.placements),
                               _placement_names(weight.placements)))
            return out
        if mesh is None:
            model.load(params, trainable=True)
            batch_in = batch
        else:
            with torch.no_grad():
                model.load(meshlib.distribute_tree(
                    params, model.param_axes(), mesh, rules),
                    trainable=True)
            batch_in = {k: meshlib.distribute(v, mesh, meshlib.sharding_for(
                ("act_batch", "act_seq"), v.shape, mesh, rules))
                for k, v in batch.items()}
        flash_xla.FlashAttention.apply = seen_apply
        trainer_mod.pin = seen_pin
        try:
            with staged_collectives(mesh):
                new, _, met = trainer_mod.make_train_step(
                    model, opt, mesh, rules)(
                    model.params, init_opt_state(model.params), batch_in)
                torch.cuda.synchronize()
                flash_xla.FlashAttention.apply = apply
                trainer_mod.pin = pin
                whole = (lambda t: t.detach().full_tensor()) if mesh \
                    else (lambda t: t.detach())
                leaves = {path: whole(t)
                          for path, t in _flat_tree(new).items()}
                grads = dict(zip(leaves, (whole(g) for g in grads)))
        finally:
            flash_xla.FlashAttention.apply, trainer_mod.pin = apply, pin
        return new, met, leaves, grads, placed

    if rank == 0:
        _, m1, p1, g1, _ = step_once(None, set())
        info["one_rank_loss"] = float(m1["loss"])
        info["one_rank_grad_norm"] = float(m1["grad_norm"])
    mesh = meshlib.make_mesh(SHARDED["mesh"], ("data", "model"),
                             device_type=DEVICE)
    heads = set()
    torch.cuda.synchronize()
    tfa.flash_attention.launches = tfa.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    params, met, leaves, grads, placed = step_once(mesh, heads)
    info.update(
        seconds=time.perf_counter() - t0, loss=float(met["loss"]),
        grad_norm=float(met["grad_norm"]),
        launches={"fwd": tfa.flash_attention.launches,
                  "bwd": tfa.flash_attention_bwd.launches},
        launches_expected={"fwd": remat_forwards(cfg),
                           "bwd": cfg.num_layers},
        kernel_inputs=sorted(heads),
        grads_in_weight_placements=all(g == w for g, w in placed),
        leaves=len(placed),
        placements={path: _placement_names(t.placements) for path, t in
                    _flat_tree(params).items() if path in (
                        "embed", "groups/0/attn/wq/w", "groups/0/mlp/down/w",
                        "final_norm")})
    # the GQA case of the production mesh: a model axis wider than the kv
    # heads (launches of this step are not the phase's count)
    gqa_mesh = meshlib.make_mesh(SHARDED["mesh"][::-1], ("data", "model"),
                                 device_type=DEVICE)
    gqa_heads = set()
    _, met24, leaves24, grads24, placed24 = step_once(gqa_mesh, gqa_heads)
    info.update(gqa_loss=float(met24["loss"]),
                gqa_grad_norm=float(met24["grad_norm"]),
                gqa_kernel_inputs=sorted(gqa_heads),
                gqa_grads_in_weight_placements=all(
                    g == w for g, w in placed24))
    info["moe_a2a"] = _moe_a2a_check()
    if rank == 0:
        def worst(got, want, rel):
            errs = {path: float((got[path] - want[path]).abs().max()
                                / (want[path].abs().max() if rel else 1))
                    for path in want}
            path = max(errs, key=errs.get)
            return errs[path], path
        info["max_abs_err"], info["worst_leaf"] = worst(leaves, p1, False)
        info["grad_err_of_max"], info["worst_grad"] = worst(grads, g1, True)
        info["gqa_grad_err_of_max"], info["gqa_worst_grad"] = worst(
            grads24, g1, True)
    dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(info))
    return 0


def _moe_a2a_check() -> dict:
    """`MOE_A2A` on this rank: the layer through `moe.apply_moe` over the
    (2, 2, 2) mesh (the a2a route, inside `staged_collectives`; its
    all-to-alls are c10d calls on CUDA tensors, which gloo takes) and
    through the dense route on whole tensors on the card, from one seeded
    init; the gradients of sum(tanh(y)) by every weight and by x."""
    import numpy as np
    import torch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import (init_params, param_axes,
                                           tree_leaves)
    cfg = ModelConfig(**MOE_A2A["layer"])
    specs = moe.moe_specs(cfg)
    full = init_params(specs, torch.Generator(device=DEVICE).manual_seed(0),
                       torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=MOE_A2A["x"]).astype(np.float32)).to(DEVICE)

    def run(params, xin):
        leaves = tree_leaves(params)
        for t in leaves + [xin]:
            t.requires_grad_()
        y = moe.apply_moe(params, xin, cfg)
        y = y.full_tensor() if meshlib.is_dtensor(y) else y
        grads = torch.autograd.grad(torch.tanh(y).sum(), leaves + [xin])
        return y.detach(), [g.full_tensor() if meshlib.is_dtensor(g) else g
                            for g in grads]
    y_dense, g_dense = run({k: t.clone() for k, t in full.items()},
                           x.clone())
    mesh = meshlib.make_mesh(MOE_A2A["mesh"], ("pod", "data", "model"),
                             device_type=DEVICE)
    rules = meshlib.DEFAULT_RULES
    params = meshlib.distribute_tree(full, param_axes(specs), mesh, rules)
    xd = meshlib.distribute(x, mesh, meshlib.sharding_for(
        ("act_batch", "act_seq", "act_embed"), MOE_A2A["x"], mesh, rules))
    routes, a2a = [], moe._apply_moe_a2a
    moe._apply_moe_a2a = lambda *a: routes.append("a2a") or a2a(*a)
    try:
        with staged_collectives(mesh), meshlib.sharding_context(mesh, rules):
            y, grads = run(params, xd)
    finally:
        moe._apply_moe_a2a = a2a
    return {"routes": routes,
            "max_abs_err": float((y - y_dense).abs().max()),
            "grad_max_abs_err": max(float((g - w).abs().max())
                                    for g, w in zip(grads, g_dense)),
            "device": y.device.type}


def start_sharded() -> tuple:
    """Start the 8 ranks of ``sharded_train_parity`` (``--worker sharded
    DIR`` processes with torchrun's variables), each logging under
    `SHARDED_DIR`."""
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    SHARDED_DIR.mkdir(parents=True)
    port, world = _free_port(), SHARDED["ranks"]
    logs = [SHARDED_DIR / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                 "sharded", str(SHARDED_DIR)], stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT),
                env={**_rank_env(r, world, port),
                     "PYTHONFAULTHANDLER": "1"},
                preexec_fn=_lower_priority))  # it has slack
    return procs, logs


def phase_sharded_train_parity(procs: list, logs: list) -> dict:
    """Wait for the 8 ranks; one line: the sharded step's gradients (each
    leaf's within 1e-4 of its max |g|), grad norm, loss and every leaf
    within 1e-4 of the one-rank step on the card, and the 2x4 step's
    gradients, grad norm and loss; each rank's launches of both f32
    attention kernels in the 4x2 step (the one-rank step's counts: each
    rank launches once a layer on its local heads), the shards the
    kernels got, and the gradients' placements against the weights'."""
    _run_ranks("sharded_train_parity", procs, logs, timeout=900)
    ranks = [json.loads((SHARDED_DIR / f"rank{r}.json").read_text())
             for r in range(SHARDED["ranks"])]
    head = ranks[0]
    out = {"phase": "sharded_train_parity", "config": "gemma2_9b smoke, "
           "f32, weight matrices at std 1/sqrt(d_in)",
           "mesh": {"data": SHARDED["mesh"][0], "model": SHARDED["mesh"][1]},
           "backend": "gloo", "batch": SHARDED["batch"],
           "seq": SHARDED["seq"], "loss": head["loss"],
           "one_rank_loss": head["one_rank_loss"],
           "max_abs_err": head["max_abs_err"],
           "worst_leaf": head["worst_leaf"],
           "grad_norm": head["grad_norm"],
           "one_rank_grad_norm": head["one_rank_grad_norm"],
           "grad_err_of_max": head["grad_err_of_max"],
           "worst_grad": head["worst_grad"],
           "gqa_mesh": {"data": SHARDED["mesh"][1],
                        "model": SHARDED["mesh"][0]},
           "gqa_loss": head["gqa_loss"],
           "gqa_grad_norm": head["gqa_grad_norm"],
           "gqa_grad_err_of_max": head["gqa_grad_err_of_max"],
           "gqa_worst_grad": head["gqa_worst_grad"],
           "gqa_kernel_inputs": head["gqa_kernel_inputs"],
           "launches_by_rank": [r["launches"] for r in ranks],
           "launches_expected": head["launches_expected"],
           "kernel_inputs": head["kernel_inputs"],
           "grads_in_weight_placements": [r["grads_in_weight_placements"]
                                          for r in ranks],
           "placements": head["placements"],
           "step_s_by_rank": [r["seconds"] for r in ranks],
           "moe_a2a": {"mesh": dict(zip(("pod", "data", "model"),
                                        MOE_A2A["mesh"])),
                       "layer": MOE_A2A["layer"], "x": MOE_A2A["x"],
                       "tol": MOE_A2A["tol"],
                       "grad_tol": MOE_A2A["grad_tol"],
                       "by_rank": [r["moe_a2a"] for r in ranks]}}
    emit(out)
    for r in ranks:
        print(f"sharded_train_parity: rank {r['rank']} launched "
              f"flash_attention {r['launches']['fwd']} and "
              f"flash_attention_bwd {r['launches']['bwd']} times on its "
              f"local heads {r['kernel_inputs']}; gradients in their "
              f"weights' placements: {r['grads_in_weight_placements']}",
              flush=True)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    ok = (abs(head["loss"] - head["one_rank_loss"]) <= SHARDED["tol"]
          and head["max_abs_err"] <= SHARDED["tol"]
          and head["grad_err_of_max"] <= SHARDED["tol"]
          and rel(head["grad_norm"], head["one_rank_grad_norm"])
          <= SHARDED["tol"]
          and abs(head["gqa_loss"] - head["one_rank_loss"]) <= SHARDED["tol"]
          and head["gqa_grad_err_of_max"] <= SHARDED["tol"]
          and rel(head["gqa_grad_norm"], head["one_rank_grad_norm"])
          <= SHARDED["tol"]
          and all(r["gqa_grads_in_weight_placements"] for r in ranks)
          and all(k[:4] == [1, 1, "Tensor", "cuda"]
                  for r in ranks for k in r["gqa_kernel_inputs"])
          and all(r["launches"] == r["launches_expected"] for r in ranks)
          and all(r["grads_in_weight_placements"] for r in ranks)
          and all(k[2] == "Tensor" and k[3] == "cuda"
                  for r in ranks for k in r["kernel_inputs"]))
    moe_ok = all(r["moe_a2a"]["routes"] == ["a2a"]
                 and r["moe_a2a"]["device"] == "cuda"
                 and r["moe_a2a"]["max_abs_err"] <= MOE_A2A["tol"]
                 and r["moe_a2a"]["grad_max_abs_err"] <= MOE_A2A["grad_tol"]
                 for r in ranks)
    if not ok:
        raise SystemExit("sharded_train_parity: the sharded step differs")
    if not moe_ok:
        raise SystemExit("sharded_train_parity: the MoE's all-to-all "
                         "dispatch differs from the dense one")
    return out


def dryrun_worker(out_dir: str) -> int:
    """The dry-run CLI (`repro_torch.launch.dryrun.main`) on each of
    `DRYRUN_CELLS`, single-pod mesh, into ``out_dir``."""
    from repro_torch.launch import dryrun
    for cell in DRYRUN_CELLS:
        t0 = time.perf_counter()
        dryrun.main([*cell, "--mesh", "single", "--out", out_dir,
                     "--force"])
        print(f"cell seconds: {time.perf_counter() - t0:.2f}", flush=True)
    return 0


def collect_dryrun(procs: dict) -> dict:
    """Wait for the dry-run worker; one line with each cell's JSON: per
    rank peak bytes, the three roofline terms, the dominant one and the
    trace seconds, each cell having printed ``DRY-RUN PASS``."""
    text = _wait_worker(procs, "dryrun")
    passes = text.count("DRY-RUN PASS")
    cells = {}
    for path in sorted(DRYRUN_DIR.glob("*.json")):
        res = json.loads(path.read_text())
        rf = res["roofline"]
        cells[path.stem] = {
            "chips": res["chips"], "kind": res["kind"],
            "peak_bytes_per_rank": res["memory"]["peak_estimate_bytes"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"], "dominant": rf["dominant"],
            "trace_s": res["lower_s"],
            "flops_per_device": rf["flops_per_device"],
            "bytes_per_device": rf["bytes_per_device"],
            "collective_bytes_per_device":
                rf["collective_bytes_per_device"],
            "model_flops_global": res["model_flops_global"],
            "useful_flops_ratio": res["useful_flops_ratio"],
            "roofline_fraction": res["roofline_fraction"],
            **({"static_bounds": res["static_bounds"]}
               if "static_bounds" in res else {})}
    out = {"phase": "dryrun", "mesh": "single-pod 16x16, fake group",
           "passes": passes, "cells": cells,
           "constants": "H100 SXM5: 989.4e12 FLOP/s bf16, 3.35e12 B/s, "
                        "450e9 B/s NVLink one way"}
    emit(out)
    for name, cell in cells.items():
        print(f"dryrun {name}: DRY-RUN PASS, peak "
              f"{cell['peak_bytes_per_rank']} B a rank, compute "
              f"{cell['compute_s']:.6f} s, memory {cell['memory_s']:.6f} s, "
              f"collective {cell['collective_s']:.6f} s, dominant "
              f"{cell['dominant']}, traced in {cell['trace_s']} s",
              flush=True)
    if passes != len(DRYRUN_CELLS) or len(cells) != len(DRYRUN_CELLS) or \
            not all(c["peak_bytes_per_rank"] > 0 for c in cells.values()):
        raise SystemExit("dryrun: a cell failed")
    return out


def _counted_step(trainer, step_fn, cfg, median_s: float) -> dict:
    """One more train step under `launch.hlo_stats.StepCounter` (its
    FLOPs, bytes and peak live bytes as the port counts them), beside
    `model_flops`' 6·N·T and the H100 roofline: its terms for the counted
    step, and the share of the bf16 peak that the measured median step's
    model FLOPs reach."""
    import torch
    from repro_torch.launch import hlo_stats, roofline
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import model_flops
    batch = trainer._batch(trainer.step)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, counter = hlo_stats.count(step_fn, trainer.params,
                                 trainer.opt_state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tokens = batch["tokens"].shape
    mf = model_flops(cfg, ShapeConfig("train", tokens[1], tokens[0],
                                      "train"))
    st = counter.stats
    rf = roofline.analyze(st, 1)
    return {"counted_flops": st.flops, "counted_bytes": st.bytes,
            "counted_peak_live_bytes": counter.peak,
            "model_flops": mf, "useful_flops_ratio": mf / st.flops,
            "roofline_terms_s": {"compute": rf.compute_s,
                                 "memory": rf.memory_s},
            "roofline_dominant": rf.dominant,
            "median_step_s": median_s,
            "roofline_fraction": roofline.measured_fraction(mf, 1,
                                                            median_s),
            "counted_step_wall_s": wall,
            "peak_flops": roofline.PEAK_FLOPS}


def _full_argv() -> list:
    """The launcher's arguments of the full graph."""
    return ["--generator", "powerlaw", "--nodes", str(FULL["nodes"]),
            "--edges", str(FULL["edges"]), "--k", str(FULL["k"]),
            "--mode", "sorted", "--device", DEVICE]


T0 = time.perf_counter()


def elapsed(after: str) -> None:
    """The script's seconds so far, after the phases named."""
    print(f"elapsed: {time.perf_counter() - T0:.1f} s after {after}",
          flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return run_worker(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import bisim as launcher

    phase_build()
    for d in (WORKER_DIR, STREAM_WORKDIR, DRYRUN_DIR):
        shutil.rmtree(d, ignore_errors=True)
    args = launcher.build_parser().parse_args(_full_argv())
    t0 = time.perf_counter()
    g = launcher.make_graph(args)
    gen_seconds = time.perf_counter() - t0
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges "
          f"({gen_seconds:.1f} s to generate)", flush=True)
    streams = {}
    try:
        kern = phase_kernels({m: _build_lanes(g, m) for m in MODES})
        chunk = phase_chunk_kernels()
        # the stream's crash drill is the longest worker (~500 s, on the
        # parity graph): its two runs start here, once the kernels are
        # timed, beside the parity, build and distributed phases
        streams = start_workers(("drill", "cpu"))
        phase_parity()
        phase_oocore_parity()
        full, inmem = phase_full(args, g, gen_seconds)
        phase_profile(args, g)
        ooc = phase_oocore(args, g, inmem)
        phase_distributed_parity()
        dist_runs = phase_distributed(save_full_graph(g), inmem)
    except BaseException:
        stop_workers(streams)
        raise
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    del inmem
    print(f"elapsed: {time.perf_counter() - T0:.1f} s", flush=True)
    # the parity phases of out-of-core maintenance and of the quotient and
    # the full graph's quotient are host-bound: worker processes run them
    # (the stream's two runs started above) beside the maintenance phases,
    # in memory and out of core; the quotient worker times its waves once
    # the others have ended, and the workers' lines print below; so do
    # the sharded step's 8 gloo ranks (the card shared, mostly host work)
    # and the dry-run (host work only)
    workers = {**streams,
               **start_workers(("parity", "quotient", "dryrun"))}
    sharded = start_sharded()
    try:
        maint, folds = phase_maintenance(g)
        try:
            ooc_maint = phase_ooc_maintenance(g)
        finally:
            shutil.rmtree(OOC_WORKDIR, ignore_errors=True)
        del g
        stream = phase_stream(workers)
        print(f"elapsed: {time.perf_counter() - T0:.1f} s", flush=True)
        sharded_out = phase_sharded_train_parity(*sharded)
        collect_dryrun(workers)
        qparity = collect_parity(workers)
        quotient = collect_quotient(workers)
    finally:
        stop_workers(workers)
        for proc in sharded[0]:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for d in (QUOTIENT_WORKDIR, STREAM_WORKDIR, WORKER_DIR,
                  OOC_PARITY_WORKDIR, SHARDED_DIR, DRYRUN_DIR):
            shutil.rmtree(d, ignore_errors=True)
    print(f"elapsed: {time.perf_counter() - T0:.1f} s", flush=True)
    frontier = phase_frontier_kernels(folds)  # alone on the card
    attn = phase_attention()
    elapsed("attention")
    attn_bwd = phase_attention_bwd()
    elapsed("attention_bwd")
    phase_mma_rate()
    phase_serve_parity()
    # minicpm3 has no logit softcap, and at the init's scale its attention
    # saturates: card and CPU in f32 alike lie ~3e-4 from float64 there,
    # ~9e-6 at the trained scale
    phase_serve_parity("minicpm3_4b", PARITY_MLA, "serve_parity_mla",
                       trained_scale=True)
    # the MoEs at 1/sqrt(d_in) as well; deepseek's line adds a train
    # step's gradients (the f32 backward at (192, 128) on a model path)
    moe_parity = {arch: phase_serve_parity(
        arch, cut, "serve_parity_moe", trained_scale=True,
        traffic=PARITY_MOE_TRAFFIC)
        for arch, cut in (("llama4_scout_17b_16e", PARITY_LLAMA4),
                          ("deepseek_v2_lite_16b", PARITY_DEEPSEEK))}
    # the SSMs at 1/sqrt(d_in); zamba2's line adds a train step's
    # gradients (the f32 backward at (112, 112), the shared block's
    # gradient summed over its layers)
    ssm_parity = {arch: phase_serve_parity(
        arch, cut, "serve_parity_ssm", trained_scale=True)
        for arch, cut in (("mamba2_780m", PARITY_MAMBA2),
                          ("zamba2_7b", PARITY_ZAMBA2))}
    # the encoder-decoder at 1/sqrt(d_in), with a train step's gradients
    # (the f32 backward at non-causal Sq > Skv, into the encoder)
    elapsed("serve_parity to serve_parity_ssm")
    encdec_parity = phase_serve_parity(
        "seamless_m4t_large_v2", PARITY_ENCDEC, "serve_parity_encdec",
        trained_scale=True)
    elapsed("serve_parity_encdec")
    serve, eng, reqs = phase_serve()
    phase_serve_profile(eng, reqs)
    del eng
    elapsed("serve and serve_profile")
    zoo = phase_serve_zoo()
    print(f"elapsed: {time.perf_counter() - T0:.1f} s", flush=True)
    train_par = phase_train_parity()
    train = phase_train()
    print(f"elapsed: {time.perf_counter() - T0:.1f} s", flush=True)
    bwd = attn_bwd["gemma2_9b_train"]["global"]
    glob = attn["gemma2_9b_prefill"]["global"]
    big = frontier["cases"]["largest dedup=True"]
    # ms: the wrapper a call (CUDA events); kernel_ms: the kernel's own
    # device time (torch.profiler; the attention rows say in
    # kernel_ms_source when events stood in); host_us: the host's time a
    # call
    times = ("ms", "kernel_ms", "host_us", "plain_ms", "bound_ms")
    # fold_flat launches a rank of the full graph's distributed runs
    dist_launches = {name: line["fold_flat_launches"]
                     for name, line in dist_runs.items()}
    # the wrappers' host time a call, now through their custom ops
    host_us = {"sig_fold": kern["host_us"],
               "frontier_sig_fold": big["host_us"],
               "flash_attention": glob["host_us"],
               "flash_attention_bwd": bwd["host_us"]}
    print("custom-op host us a call (before the ops): " + ", ".join(
        f"{name} {us:.1f} ({HOST_US_BEFORE_OPS[name]})"
        for name, us in host_us.items()), flush=True)
    dispatch = dispatch_us()
    emit({"phase": "op_dispatch", "host_us_a_call": dispatch,
          "inputs": "sig_fold 4,096 lanes / 256 rows; attention bf16 "
          "1 x 4/2 heads x 128 tokens x 64"})
    # MLA's (96, 64) pair at minicpm3-4b's shapes, (192, 128) at
    # deepseek-v2-lite's and (112, 112) at zamba2-7b's, the serve_zoo's
    # and the MoE and SSM serve parities' launches and the (D, Dv) pairs
    # the libraries are built for
    mla_keys = (*times, "bound_by", "library_ms", "library_note",
                "kernel_ms_source", "back_to_back_ms", "max_abs_err",
                "case")
    mla_bwd_keys = tuple(k for k in mla_keys if k != "max_abs_err") + (
        "err_of_max", "fwd_ms", "fwd_bound_ms", "library_fwd_ms")
    pairs = attn["built_pairs"]
    zoo_launches = {arch: line["flash_attention_launches"]
                    for arch, line in zoo.items()}
    sharded_launches = {"fwd": [r["fwd"] for r in
                                sharded_out["launches_by_rank"]],
                        "bwd": [r["bwd"] for r in
                                sharded_out["launches_by_rank"]]}
    emit({"kernels": [{
        "name": "sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:113",
        "launches": full["runs"][0]["sig_fold_launches"],
        "quotient_launches": quotient["build_sig_fold_launches"],
        "quotient_parity_launches": qparity["build_sig_fold_launches"],
        "distributed_launches": dist_launches,
        "max_abs_err": kern["max_abs_err"],
        **{k: kern[k] for k in times}, "shape": kern["shape"],
        "custom_op": "repro_torch::sig_fold",
        "bound_by": "bytes", "library_ms": None}, {
        "name": "frontier_sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:199",
        "launches": maint["frontier_sig_fold_launches"],
        "ooc_maintenance_launches": ooc_maint["frontier_sig_fold_launches"],
        "quotient_launches": quotient["frontier_sig_fold_launches"],
        "quotient_parity_launches": qparity["frontier_sig_fold_launches"],
        "stream_launches": stream["frontier_sig_fold_launches"],
        "distributed_launches": dist_launches,
        "max_abs_err": frontier["max_abs_err"],
        **{k: big[k] for k in times}, "shape": big["shape"],
        "median_batch": {k: frontier["cases"]["median dedup=True"][k]
                         for k in (*times, "shape")},
        "custom_op": "repro_torch::sig_fold",
        "bound_by": "bytes", "library_ms": None}, {
        "name": "chunk_sig_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sig_fold.cu",
        "replaces": "src/repro/kernels/sig_fold.py:221",
        "launches": ooc["chunk_sig_fold_launches"],
        "ooc_maintenance_launches": ooc_maint["chunk_sig_fold_launches"],
        "stream_launches": stream["chunk_sig_fold_launches"],
        "max_abs_err": chunk["max_abs_err"],
        **{k: chunk[k] for k in times}, "shape": chunk["shape"],
        "build_mean_chunk": {k: chunk["shapes"]["build mean chunk"][k]
                             for k in (*times, "shape")},
        "bound_by": "bytes", "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": serve["flash_attention_launches"],
        "train_launches": train["launches"]["fwd"],
        "sharded_f32_launches_by_rank": sharded_launches["fwd"],
        "custom_op": "repro_torch::flash_attention",
        "max_abs_err": attn["max_abs_err"], **{k: glob[k] for k in times},
        "kernel_ms_source": glob["kernel_ms_source"],
        "back_to_back_ms": glob["back_to_back_ms"],
        "bound_by": glob["bound_by"], "library_ms": glob["library_ms"],
        "mla_source":
            "src/repro_torch/kernels/csrc/flash_attention_sm90_mla.cu",
        "built_pairs": pairs, "serve_zoo_launches": zoo_launches,
        "mla": {dtype: {k: row[k] for k in mla_keys} for dtype, row in
                attn["minicpm3_4b_prefill"].items()},
        "deepseek_mla": {dtype: {k: row[k] for k in mla_keys}
                         for dtype, row in
                         attn["deepseek_v2_lite_16b_prefill"].items()},
        "serve_parity_moe_launches": {
            arch: {"launches": line["flash_attention_launches"],
                   "kernel_calls": line["kernel_calls"]}
            for arch, line in moe_parity.items()},
        "zamba2_hd112": {dtype: {k: row[k] for k in mla_keys}
                         for dtype, row in
                         attn["zamba2_7b_prefill"].items()},
        "serve_parity_ssm_launches": {
            arch: {"launches": line["flash_attention_launches"],
                   "kernel_calls": line["kernel_calls"]}
            for arch, line in ssm_parity.items()},
        "seamless": {dtype: {case: {k: row[k] for k in (*mla_keys,
                                                         "plain_rows")}
                             for case, row in by_case.items()}
                     for dtype, by_case in
                     attn["seamless_m4t_large_v2"].items()},
        "serve_parity_encdec_launches": {
            "launches": encdec_parity["flash_attention_launches"],
            "train_fwd_launches": encdec_parity["train_step"][
                "fwd_launches"],
            "kernel_calls": encdec_parity["kernel_calls"]}}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "f32_source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "no Pallas kernel: the JAX package differentiates in "
                    "XLA, src/repro/models/flash_xla.py:100 (_bwd_rule)",
        "launches": train["launches"]["bwd"],
        "sharded_f32_launches_by_rank": sharded_launches["bwd"],
        "custom_op": "repro_torch::flash_attention_bwd",
        "max_abs_err": attn_bwd["max_abs_err"],
        **{k: bwd[k] for k in times}, "shape": bwd["case"],
        "kernel_ms_source": bwd["kernel_ms_source"],
        "back_to_back_ms": bwd["back_to_back_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "f32_route": {name: {k: row[k] for k in (
            *times, "bound_by", "library_ms", "fwd_ms", "fwd_bound_ms",
            "library_fwd_ms")} for name, row in
            attn_bwd["f32_routes"].items()},
        "mla_source":
            "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90_mla.cu",
        "built_pairs": pairs,
        "mla": {dtype: {k: row[k] for k in mla_bwd_keys} for dtype, row in
                attn_bwd["minicpm3_4b_train"].items()},
        "deepseek_mla": {dtype: {k: row[k] for k in mla_bwd_keys}
                         for dtype, row in
                         attn_bwd["deepseek_v2_lite_16b_train"].items()},
        "serve_parity_moe_train_launches": {
            "deepseek_v2_lite_16b": moe_parity["deepseek_v2_lite_16b"][
                "train_step"]["bwd_launches"]},
        "zamba2_hd112": {dtype: {k: row[k] for k in mla_bwd_keys}
                         for dtype, row in
                         attn_bwd["zamba2_7b_train"].items()},
        "serve_parity_ssm_train_launches": {
            "zamba2_7b": ssm_parity["zamba2_7b"]["train_step"][
                "bwd_launches"]},
        "seamless": {dtype: {case: {k: row[k] for k in mla_bwd_keys}
                             for case, row in by_case.items()}
                     for dtype, by_case in
                     attn_bwd["seamless_m4t_large_v2_train"].items()},
        "serve_parity_encdec_train_launches": encdec_parity["train_step"][
            "bwd_launches"]}, {
        # the f32 routes (3xTF32 on the tensor cores): their main path is
        # train_parity's step (launches a step, counted from 0), timed at
        # its shape; gemma2's train shape and seamless's decode beside
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "mla_source": "src/repro_torch/kernels/csrc/flash_attention_mla.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": train_par["launches_a_step"]["fwd"],
        "sharded_launches_by_rank": sharded_launches["fwd"],
        "custom_op": "repro_torch::flash_attention",
        **_f32_entry(attn_bwd["f32_routes"], "fwd_"),
        "seamless_decode": {k: attn["seamless_m4t_large_v2"]["float32"][
            "cross_decode"][k] for k in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "share_of_bound")}}, {
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "mla_source":
            "src/repro_torch/kernels/csrc/flash_attention_bwd_mla.cu",
        "replaces": "no Pallas kernel: the JAX package differentiates in "
                    "XLA, src/repro/models/flash_xla.py:100 (_bwd_rule)",
        "launches": train_par["launches_a_step"]["bwd"],
        "sharded_launches_by_rank": sharded_launches["bwd"],
        "custom_op": "repro_torch::flash_attention_bwd",
        **_f32_entry(attn_bwd["f32_routes"], "")}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
