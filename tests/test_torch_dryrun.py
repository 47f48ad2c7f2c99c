"""The port's dry-run machinery (`repro_torch.launch.{roofline,hlo_stats,
dryrun}`) and the custom ops the trace goes through: the counterparts of
`tests/test_dryrun.py` for the ported architectures.

The fake process groups (256 ranks, or 16 for the collective checks) live
in subprocesses, so no test leaves a group behind.  The dry-run CLI's JSON
keys are held to the reference's, read from `src/repro/launch/dryrun.py`'s
own dicts (its cells need 512 XLA devices, which the port's do not).
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import sig_fold as tfold  # noqa: E402
from repro_torch.kernels.ref import attention_mask  # noqa: E402
from repro_torch.launch import hlo_stats, roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _ref_keys(function: str) -> set:
    """The keys of the largest dict literal of `function` in the
    reference's dry-run: the cell's result."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    out = max((n for n in ast.walk(fn) if isinstance(n, ast.Dict)),
              key=lambda n: len(n.keys))
    return {k.value for k in out.keys}


def test_roofline_math():
    r = roofline.Roofline(compute_s=1.0, memory_s=2.0, collective_s=0.5,
                          flops_per_device=1.0, bytes_per_device=1.0,
                          collective_bytes_per_device=1.0,
                          collective_breakdown={}, chips=256)
    assert r.dominant == "memory"
    assert r.step_time_s == 2.0
    # useful time = mf / chips / peak; one second of the port's own peak
    mf = roofline.PEAK_FLOPS * 256
    assert abs(r.fraction_of_roofline(mf) - 0.5) < 1e-9
    assert abs(roofline.measured_fraction(mf, 256, 4.0) - 0.25) < 1e-12
    assert set(r.to_dict()) == {
        "compute_s", "memory_s", "collective_s", "dominant",
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collective_breakdown", "chips",
        "step_time_s"}


def test_roofline_holds_the_h100s_constants():
    """H100 SXM5: dense bf16 989.4 TFLOP/s, HBM3 3.35 TB/s, NVLink 900 GB/s
    both ways (450 GB/s one way); none of the reference's TPU figures."""
    from repro.launch import roofline as ref
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)
    consts = {roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW}
    assert not consts & {ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW}
    src = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    for tpu in ("197e12", "819e9", "50e9"):
        assert tpu not in src


def test_step_counter_counts_nested_loops():
    """The counterpart of `test_hlo_stats_counts_scan_trips`: 5 x 3 nested
    ``tanh(c @ w)`` at 64 x 64 count 15 * 2 * 64^3 FLOPs within 2%."""
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return torch.sum(x)
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    _, counter = hlo_stats.count(f, x, w)
    expect = 15 * 2 * 64 * 64 * 64
    assert abs(counter.stats.flops - expect) / expect < 0.02
    # mm and tanh: two 16 KB inputs or outputs each, one 16 KB output
    assert counter.stats.bytes >= 15 * (3 + 2) * 64 * 64 * 4
    assert counter.stats.collective_bytes == 0
    assert counter.peak >= 3 * 64 * 64 * 4


def test_step_counter_tracks_fake_memory():
    """Live bytes rise with each new storage and fall when it is freed:
    the peak of a + 2a + 2a + 2a with one temporary freed is 3 tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(1000, 1000)

        def g(a):
            b = a * 2
            c = b + 1
            del b
            return c * 3
        _, counter = hlo_stats.count(g, a)
    assert counter.peak == 3 * 4_000_000
    assert counter.live == 2 * 4_000_000


FAKE_SCRIPT = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, "src")
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import dryrun, hlo_stats

    out = {}
    dryrun.fake_world(16)
    mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4),
                      mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(16, 64), mesh,
                               [Shard(0), Replicate()])
        p = DTensor.from_local(torch.empty(64, 64), mesh,
                               [Partial(), Replicate()])
        w = DTensor.from_local(torch.empty(64, 4096), mesh,
                               [Replicate(), Replicate()])
        plain = torch.empty(100)

        def step(x, p, w, plain):
            a = x.redistribute(mesh, [Replicate(), Replicate()])
            b = p.redistribute(mesh, [Shard(0), Replicate()])
            c = x @ w
            dist.all_reduce(plain)
            send = torch.empty(16, 8)
            dist.all_to_all_single(torch.empty_like(send), send)
            return a, b, c
        _, counter = hlo_stats.count(step, x, p, w, plain)
    st = counter.stats
    out["collectives"] = st.collectives
    out["counts"] = st.collective_counts
    out["flops"] = st.flops
    for ranking in ("allgather", "bucketed"):
        out[ranking] = dryrun.lower_bisim_cell(
            multi_pod=False, ranking=ranking, log2_nodes=16,
            log2_edges=18)
    dist.destroy_process_group()
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def fake_run():
    proc = subprocess.run([sys.executable, "-c", FAKE_SCRIPT], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collective_bytes_of_known_redistributions(fake_run):
    """Under a fake 4x4 group: a [64, 64] f32 gathered from a 4-way split
    (16 KB, the gathered result), a Partial sum reduce-scattered (16 KB,
    the full operand), an all-reduce of 400 B counted twice, an
    all-to-all of what the rank sends (512 B)."""
    coll, counts = fake_run["collectives"], fake_run["counts"]
    assert coll["all-gather"] == 64 * 64 * 4 and counts["all-gather"] == 1
    assert coll["reduce-scatter"] == 64 * 64 * 4
    assert counts["reduce-scatter"] == 1
    assert coll["all-reduce"] == 2 * 400 and counts["all-reduce"] == 1
    assert coll["all-to-all"] == 16 * 8 * 4 and counts["all-to-all"] == 1


def test_step_counter_counts_a_ranks_local_flops(fake_run):
    """A matmul of a batch split 4 ways counts the rank's share: 2 * 16 *
    64 * 4096 FLOPs, not the global 2 * 64 * 64 * 4096."""
    assert fake_run["flops"] == 2 * 16 * 64 * 4096


@pytest.mark.parametrize("ranking", ["allgather", "bucketed"])
def test_lower_bisim_cell(fake_run, ranking):
    """One iteration at n = 2^16, e = 2^18 over 256 fake ranks: the
    reference's keys plus the static bounds, the fold as the custom op,
    the ranking's collectives at their static sizes."""
    res = fake_run[ranking]
    assert set(res) - _ref_keys("lower_bisim_cell") == {"static_bounds"}
    assert _ref_keys("lower_bisim_cell") <= set(res)
    assert res["chips"] == 256 and res["kind"] == "bisim_iteration"
    assert res["arch"] == f"bisim[sorted,{ranking}]"
    assert res["shape"] == "n=2^16,e=2^18"
    assert res["memory"]["peak_estimate_bytes"] > 0
    rf = res["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    n_loc = -(-(2 ** 16 + 1) // 256)
    coll = rf["collective_breakdown"]
    # every rank's pid column is gathered (int32)
    assert coll["all-gather"] >= 4 * n_loc * 256
    if ranking == "allgather":
        assert res["static_bounds"] == {"allgather_keys": n_loc * 256}
        assert coll["all-gather"] == (4 + 8) * n_loc * 256
    else:
        cap = res["static_bounds"]["capacity"]
        assert res["static_bounds"]["bucket_slots"] == 256 * cap
        # keys (int64), valid flags (uint8) out, ranks (int32) back
        assert coll["all-to-all"] == (8 + 1 + 4) * 256 * cap
        assert coll["all-reduce"] == 2 * 2 * 8


def test_dryrun_cli_decode_cell(tmp_path):
    """gemma2-9b x decode_32k on the single-pod mesh through the CLI: the
    full model over 256 fake ranks, the reference's keys, a positive
    peak, one of the three terms dominant."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "gemma2_9b", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=570, env=_env())
    assert "DRY-RUN PASS" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.load(open(tmp_path / "gemma2_9b_decode_32k_single.json"))
    assert set(out) == _ref_keys("lower_cell")
    assert out["chips"] == 256
    assert out["num_params"] == 9_241_404_928
    assert out["memory"]["peak_estimate_bytes"] > 0
    assert set(out["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    assert out["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert out["compile_s"] is None
    # a second run finds the cell cached
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "gemma2_9b", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=120, env=_env())
    assert "[skip cached] gemma2_9b_decode_32k_single" in r.stdout


# ------------------------------------------------------------ custom ops
def _attn_args(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 24, 16, generator=g, dtype=dtype)
    k = torch.randn(1, 2, 32, 16, generator=g, dtype=dtype)
    v = torch.randn(1, 2, 32, 16, generator=g, dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("op", ["sig_fold", "flash_attention",
                                "flash_attention_bwd"])
def test_custom_ops_pass_opcheck(op):
    """Schema, fake implementation (the plain route's shapes, dtypes and
    strides), autograd registration and AOT dispatch of each op, through
    the plain route on the CPU."""
    if op == "sig_fold":
        rng = np.random.default_rng(0)
        n = 256
        args = (torch.from_numpy(rng.integers(0, 3, n, dtype=np.int32)),
                torch.from_numpy(rng.integers(0, 50, n, dtype=np.int32)),
                torch.from_numpy(np.sort(rng.integers(0, 64, n,
                                                      dtype=np.int32))),
                torch.from_numpy(rng.random(n) < 0.9), 64, n, True, True)
    else:
        q, k, v = _attn_args()
        if op == "flash_attention":
            args = (q, k, v, True, 8, 50.0, None, 128, 128, None, True)
        else:
            o, lse = tfa.flash_attention(q, k, v, return_lse=True,
                                         window=8, softcap=50.0)
            args = (q, k, v, o, lse, torch.randn_like(o), True, 8, 50.0,
                    None, None)
    res = torch.library.opcheck(getattr(torch.ops.repro_torch, op), args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (24, 32, True, None, None), (32, 32, True, 8, None),
    (32, 32, False, None, None), (16, 40, True, 5, 3),
    (8, 8, True, 0, None), (12, 20, False, 4, -2)])
def test_visible_pairs_is_the_masks_count(sq, skv, causal, window,
                                          q_offset):
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          device="cpu", q_offset=q_offset)
    assert tfa.visible_pairs(sq, skv, causal=causal, window=window,
                             q_offset=q_offset) == int(mask.sum())


def test_attention_ops_count_their_flops():
    """`FlopCounterMode` reads the ops' formulas: 4 D a visible pair and
    head forward, 10 D backward, whatever the plain route computes."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = _attn_args()
    pairs = tfa.visible_pairs(24, 32, causal=True, window=8)
    with FlopCounterMode(display=False) as fc:
        o, lse = tfa.flash_attention(q, k, v, return_lse=True, window=8)
    assert fc.get_total_flops() == 4 * 16 * 4 * pairs
    with FlopCounterMode(display=False) as fc:
        tfa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o),
                                window=8)
    assert fc.get_total_flops() == 10 * 16 * 4 * pairs


def test_fake_tensors_reach_the_ops_and_launch_nothing():
    """A fake tensor takes the wrappers' custom ops (their fake
    implementations), on the CPU as the dry-run traces: shapes come back,
    no launch is counted, nothing reaches ctypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.flash_xla import attend_flash
    before = (tfold.sig_fold.launches, tfa.flash_attention.launches,
              tfa.flash_attention_bwd.launches)
    with FakeTensorMode():
        n = 4096
        out = tfold.frontier_sig_fold(
            torch.empty(n, dtype=torch.int32),
            torch.empty(n, dtype=torch.int32),
            torch.empty(n, dtype=torch.int32),
            torch.empty(n, dtype=torch.bool), num_sigs=100, dedup=True)
        assert out.shape == (2, 100) and out.dtype == torch.int64
        q = torch.empty(2, 64, 4, 32, requires_grad=True)
        kv = torch.empty(2, 64, 2, 32, requires_grad=True)
        o = attend_flash(q, kv, kv, causal=True, window=None, softcap=None)
        o.sum().backward()
        assert o.shape == q.shape and q.grad.shape == q.shape
    assert (tfold.sig_fold.launches, tfa.flash_attention.launches,
            tfa.flash_attention_bwd.launches) == before
