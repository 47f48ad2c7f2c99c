"""Dry-run of the production meshes: one step of each cell traced at full
size on one host, holding no device memory (the port of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_9b \
        --shape decode_32k --mesh single --out runs/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch bisim \
        --mesh single --bisim-ranking bucketed

A cell runs in this one process as rank 0 of a fake process group of 256
(single-pod, 16x16) or 512 (multi-pod, 2x16x16) ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once) under `FakeTensorMode`: parameters, optimizer state, inputs and every
activation are fake tensors (shapes, no storage), DTensors placed by
`repro_torch.launch.mesh`.  The step runs eagerly through the real call
sites (the kernels' custom ops give their shapes and FLOPs) while
`hlo_stats.StepCounter` counts a rank's FLOPs, bytes, collective bytes and
peak live bytes; `roofline` turns them into the H100's three terms.

The JSON keys are the reference's.  ``lower_s`` is the trace's seconds.
Keys with no counterpart are ``null``: ``compile_s`` (nothing is
compiled), and XLA's ``cost_analysis`` fields, which the reference prints
and keeps beside its own counts (``xla_cost_analysis_flops``,
``xla_cost_analysis_bytes`` in ``roofline.collective_breakdown``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..models import encdec, layers, lm
from ..models.config import SHAPES, supports_shape
from ..models.model import Model, model_flops
from ..optim import OptConfig
from . import mesh as meshlib
from . import hlo_stats, roofline

# the fake tensors' device: the trace needs no card (a fake tensor takes
# the kernels' custom ops on either device)
DEVICE = "cpu"


def fake_world(chips: int) -> None:
    """This process as rank 0 of a fake process group of ``chips`` ranks
    (a group already started is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)


def fake_mesh(*, multi_pod: bool):
    """The production mesh over a fake group (no card is touched)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = meshlib.production_shape(multi_pod=multi_pod)
    chips = math.prod(shape)
    fake_world(chips)
    return DeviceMesh(DEVICE, torch.arange(chips).view(shape),
                      mesh_dim_names=axes), chips


def _fake_dtensor(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` whose local shard is a fresh fake
    tensor (call under `FakeTensorMode`)."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=DEVICE), mesh,
        list(placements), shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _sharded(shapes, axes, mesh, rules):
    """Fake DTensors of a tree of meta tensors, placed by its axes."""
    return meshlib.tree_map_axes(
        lambda ax, t: _fake_dtensor(
            t.shape, t.dtype, mesh,
            meshlib.sharding_for(ax, t.shape, mesh, rules)), axes, shapes)


def _trace(fn, args, track=()):
    """`hlo_stats.count` of ``fn(*args)`` with ``track`` live too;
    returns (seconds, counter, memory summary)."""
    t0 = time.perf_counter()
    out, counter = hlo_stats.count(fn, *args, track=track)
    seconds = time.perf_counter() - t0
    return seconds, counter, roofline.memory_summary(counter, (args, track),
                                                     out)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rules_extra=None, remat=True):
    """Trace one (arch x shape x mesh) cell's step; return its stats dict.
    ``remat`` is the reference's argument; the train kind always runs its
    sqrt remat here, as it does in the reference."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": "long_500k requires sub-quadratic attention "
                           "(full-attention arch)"}
    mesh, chips = fake_mesh(multi_pod=multi_pod)
    model = Model(cfg)
    rules = meshlib.rules_for_shape(shape_name)
    if rules_extra:
        rules.update(rules_extra)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _sharded(model.param_shapes(torch.bfloat16),
                          model.param_axes(), mesh, rules)
        model.load(params, trainable=shape.kind == "train")
        in_specs, in_axes = model.input_specs(shape, torch.bfloat16)
        index = in_specs.pop("index", None)
        in_axes.pop("index", None)
        batch = _sharded(in_specs, in_axes, mesh, rules)
        if shape.kind == "train":
            from ..optim import init_opt_state
            from ..train.trainer import make_train_step
            opt = init_opt_state(model.params)
            opt["step"] = 0  # AdamW reads the step on the host: not traced
            step_fn = make_train_step(model, OptConfig(), mesh, rules)
            lower_s, counter, mem = _trace(step_fn, (model.params, opt,
                                                     batch))
        elif shape.kind == "prefill":
            def prefill_step(tokens, extra=None):
                # the last position's logits, as the reference's
                # logits[:, -1] (which XLA computes alone): the head runs
                # on that position's hidden state only; ``extra``: a vlm's
                # patch embeddings or an encoder-decoder's frames
                params = model.params
                with meshlib.sharding_context(mesh, rules):
                    if cfg.is_encoder_decoder:
                        hidden, cache = encdec.encdec_forward(
                            params, cfg, extra, tokens, kind="prefill",
                            return_hidden=True)
                        return layers.linear(params["lm_head"],
                                             hidden[:, -1:])[:, 0], cache
                    hidden, cache = lm.lm_forward(
                        params, cfg, tokens, kind="prefill",
                        patch_embeds=extra, return_hidden=True)
                    return lm._logits(params, cfg,
                                      hidden[:, -1:])[:, 0], cache
            extra = batch.get("frames", batch.get("patch_embeds"))
            lower_s, counter, mem = _trace(
                prefill_step, (batch["tokens"], extra), model.params)
        else:  # decode
            assert index is not None

            def serve_step(cache, token):
                with meshlib.sharding_context(mesh, rules):
                    return model.decode_step(cache, token,
                                             shape.seq_len - 1)
            lower_s, counter, mem = _trace(serve_step, (batch["cache"],
                                                        batch["token"]),
                                           model.params)
    rf = roofline.analyze(counter.stats, chips)
    rf.collective_breakdown.update(xla_cost_analysis_flops=None,
                                   xla_cost_analysis_bytes=None)
    mf = model_flops(cfg, shape)
    hlo_flops_global = rf.flops_per_device * chips
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": chips, "kind": shape.kind,
        "num_params": model.num_params(),
        "lower_s": round(lower_s, 2), "compile_s": None,
        "memory": mem,
        "roofline": rf.to_dict(),
        "model_flops_global": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": mf / hlo_flops_global if hlo_flops_global
        else None,
        "roofline_fraction": rf.fraction_of_roofline(mf),
    }


# ----------------------------------------------------------- paper cell
def lower_bisim_cell(*, multi_pod: bool, mode: str = "sorted",
                     ranking: str = "allgather", log2_nodes: int = 28,
                     log2_edges: int = 31):
    """Dry-run of one iteration of the paper's distributed Build_Bisim
    (`core.distributed.iteration`) on a rank's shard: n = 2^log2_nodes
    nodes range-sharded and e = 2^log2_edges edges owner-sharded over the
    mesh's ranks, every edge lane valid (the static bound of a rank's
    edges).  The host's read of [count, overflow] follows the iteration
    and is not traced.  The iteration has no data-dependent shape (its
    dense rank sorts, and the bucket sizes are a static-size
    ``index_add_``), so no symbolic shapes are needed; the bytes that
    depend on the data take their static bound, written into
    ``static_bounds``: n_loc * D gathered keys for ``allgather``, D *
    capacity bucket slots each way for ``bucketed``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core import distributed as dmod
    mesh, chips = fake_mesh(multi_pod=multi_pod)
    del mesh  # the iteration runs over the flat group of every rank
    n, e = 2 ** log2_nodes, 2 ** log2_edges
    n_loc = -(-(n + 1) // chips)
    n_pad = n_loc * chips
    e_loc = -(-e // chips)
    cap = dmod._capacity(n_loc, chips, 2.0)  # the reference's factor here
    i32 = dict(dtype=torch.int32, device=DEVICE)
    with FakeTensorMode(allow_non_fake_inputs=True):
        shard = dmod._Shard(torch.empty(n_loc, **i32),
                            *(torch.empty(e_loc, **i32) for _ in range(3)),
                            (0, 7))  # eight edge labels
        pid_loc = torch.empty(n_loc, **i32)

        def step(pid_loc):
            return dmod.iteration(
                pid_loc, shard, None, rank=0, d=chips, n_loc=n_loc,
                n_pad=n_pad, mode=mode, ranking=ranking, capacity=cap)
        lower_s, counter, mem = _trace(step, (pid_loc,), shard)
    rf = roofline.analyze(counter.stats, chips)
    rf.collective_breakdown.update(xla_cost_analysis_flops=None,
                                   xla_cost_analysis_bytes=None)
    bounds = ({"allgather_keys": n_loc * chips} if ranking == "allgather"
              else {"capacity": cap, "bucket_slots": chips * cap})
    return {
        "arch": f"bisim[{mode},{ranking}]", "shape":
            f"n=2^{log2_nodes},e=2^{log2_edges}", "multi_pod": multi_pod,
        "chips": chips, "kind": "bisim_iteration",
        "lower_s": round(lower_s, 2), "compile_s": None,
        "memory": mem, "roofline": rf.to_dict(),
        # one iteration's useful work ~ hashing+ranking every edge: treat
        # bytes as the model cost; flops ratio is not meaningful here.
        "model_flops_global": None, "hlo_flops_global":
            rf.flops_per_device * chips, "useful_flops_ratio": None,
        "roofline_fraction": None, "static_bounds": bounds,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} | all (those) | bisim")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} | all")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--bisim-mode", default="sorted")
    ap.add_argument("--bisim-ranking", default="allgather")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [m.strip() for m in args.mesh.split(",")]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    try:
        for mp_name in meshes:
            multi_pod = mp_name == "multi"
            for arch in archs:
                if arch == "bisim":
                    cells = [(f"bisim_{args.bisim_mode}_"
                              f"{args.bisim_ranking}_{mp_name}",
                              lambda: lower_bisim_cell(
                                  multi_pod=multi_pod, mode=args.bisim_mode,
                                  ranking=args.bisim_ranking))]
                else:
                    cells = [(f"{arch}_{shape}_{mp_name}",
                              lambda a=arch, s=shape: lower_cell(
                                  a, s, multi_pod=multi_pod))
                             for shape in shapes]
                for tag, run in cells:
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip cached] {tag}")
                        continue
                    try:
                        res = run()
                    except Exception as ex:  # noqa: BLE001
                        failures.append((tag, str(ex)))
                        traceback.print_exc()
                        continue
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    _report(res)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, ex in failures:
            print(f"  {tag}: {ex[:300]}")
        raise SystemExit(1)
    print("\nDRY-RUN PASS")


def _report(res: dict) -> None:
    if res.get("skipped"):
        print(f"[SKIP] {res['arch']} x {res['shape']} "
              f"({'multi' if res['multi_pod'] else 'single'}): "
              f"{res['skipped']}")
        return
    mem = res.get("memory", {})
    rf = res.get("roofline", {})
    peak_gb = mem.get("peak_estimate_bytes", 0) / 2**30
    print(f"[OK] {res['arch']} x {res['shape']} "
          f"({'multi' if res['multi_pod'] else 'single'}-pod, "
          f"{res['chips']} chips) "
          f"mem/dev={peak_gb:.2f}GiB "
          f"compute={rf.get('compute_s', 0):.4f}s "
          f"memory={rf.get('memory_s', 0):.4f}s "
          f"coll={rf.get('collective_s', 0):.4f}s "
          f"dom={rf.get('dominant')} "
          f"lower={res['lower_s']}s compile={res['compile_s']}", flush=True)


if __name__ == "__main__":
    main()
