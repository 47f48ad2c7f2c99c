"""The port's training slice (`repro_torch.optim`, `.train`, `.checkpoint`,
`.data`, the train kind of `.models` and `launch.train`) against the JAX
package's, on the same numpy inputs and one parameter tree carried across
(`params_from_jax`), on the CPU route:

- ``loss_fn`` and its gradients: loss within 1e-5 relative, each leaf's
  gradient within 1e-4 of its largest |g|.  The tree is the reference's
  init with each weight matrix rescaled to std 1/sqrt(its input width),
  as a trained model keeps its activations O(1): at the init's own scale
  (the stacked [G, ...] weights draw std 1/sqrt(G)) the smoke configs'
  attention saturates, and f32 gradients in both packages lie up to
  1.6e-4 of max |g| from a float64 evaluation, so f32 rounding rather
  than the port would decide a 1e-4 bar (rescaled: ~2e-6);
- AdamW fed identical gradients (Adam's first step is sign(g), which
  would magnify noise in near-zero gradients): params, m, v, grad_norm
  and lr within 1e-6 relative;
- five `Trainer` steps: losses within 1e-4 relative; the launcher's
  lines;
- `TokenPipeline` batches equal; checkpoints restore across packages
  with arrays equal, and an async save is not torn by the next step;
- `compressed_psum` over gloo groups of 2 and 4 ranks against the
  reference's on fake CPU devices at the same count, within one int8
  step;
- the cases of `tests/test_runtime.py`, through the port.
"""
import io
import os
import subprocess
import sys
import tempfile
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypo_compat import given, strategies as st

from repro import optim as ref_optim
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_smoke_config as ref_smoke
from repro.data import PipelineConfig as RefPipelineConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.launch import train as ref_launcher
from repro.models.model import Model as RefModel
from repro.train import Trainer as RefTrainer

torch = pytest.importorskip("torch")
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               dequantize_int8, ef_compress, init_opt_state,
                               quantize_int8, schedule_lr)
from repro_torch.train import StragglerMonitor, Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma2_9b", "phi4_mini_3p8b"]


def _ref_params(arch, seed=0):
    cfg = ref_smoke(arch)
    return jax.tree.map(np.asarray, RefModel(cfg).init(
        jax.random.PRNGKey(seed), jnp.float32))


# the weight matrices of a parameter tree: linear layers' ``w``, an MoE
# block's router and stacked experts ([G, E, d_in, d_out]), and an SSM
# block's projections
WEIGHT_KEYS = ("w", "router", "w_gate", "w_up", "w_down", "in_proj",
               "out_proj")


def _trained_scale(tree):
    """Each weight matrix (`WEIGHT_KEYS`: stacked [G, ..., d_in, d_out]
    or [d_in, d_out]) rescaled from the init's std 1/sqrt(shape[0]) to
    1/sqrt(d_in)."""
    def fix(path, a):
        if path[-1].key in WEIGHT_KEYS:
            return a * np.float32(np.sqrt(a.shape[0] / a.shape[-2]))
        return a
    return jax.tree_util.tree_map_with_path(fix, tree)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ----------------------------------------------------------- loss, grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rng = np.random.default_rng(0)
    cfg = get_smoke_config(arch)
    jp = _trained_scale(_ref_params(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
             "labels": rng.integers(-1, cfg.vocab_size, (2, 32))}
    want_loss, want = jax.value_and_grad(RefModel(ref_smoke(arch)).loss_fn)(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    m = Model(cfg).load(params_from_jax(jp, device="cpu"), trainable=True)
    loss = m.loss_fn(m.params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(m.params))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for g, w in zip(grads, jax.tree.leaves(want)):
        assert _rel(g.numpy(), w) <= 1e-4


def test_lm_loss_matches_reference():
    from repro.models.lm import lm_loss as ref_loss
    from repro_torch.models.lm import lm_loss
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 136)).astype(np.float32)
    labels = rng.integers(-1, 128, (2, 8))
    want = float(ref_loss(jnp.asarray(logits), jnp.asarray(labels), 128))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        128))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_remat_forward_count():
    """The train kind runs a layer's forward up to three times (two-level
    remat, `_sqrt_split`) and its backward once: counted through the
    plain forward and backward on a 12-layer config (G = 6 = 3 x 2)."""
    from repro_torch.models import flash_xla
    from repro_torch.models.lm import _sqrt_split, remat_forwards
    cfg = get_smoke_config("gemma2_9b").scaled(num_layers=12)
    assert _sqrt_split(cfg.pattern_groups) == (3, 2)
    m = Model(cfg).init(0, torch.float32, "cpu", trainable=True)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = (flash_xla.flash_attention_fwd_plain,
                flash_xla.flash_attention_bwd_plain)

    def count(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    try:
        flash_xla.flash_attention_fwd_plain = count("fwd", fwd)
        flash_xla.flash_attention_bwd_plain = count("bwd", bwd)
        toks = torch.zeros(1, 16, dtype=torch.int64)
        loss = m.loss_fn(m.params, {"tokens": toks, "labels": toks})
        assert calls == {"fwd": 12, "bwd": 0}
        torch.autograd.grad(loss, tree_leaves(m.params))
    finally:
        flash_xla.flash_attention_fwd_plain = fwd
        flash_xla.flash_attention_bwd_plain = bwd
    assert calls == {"fwd": remat_forwards(cfg), "bwd": 12}
    assert remat_forwards(cfg) == 30  # 3 x 2 x (3 + 2)


# ------------------------------------------------------------------ AdamW
def test_adamw_matches_reference_on_identical_grads():
    rng = np.random.default_rng(2)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 2, 4)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    cfg_kw = dict(lr=0.05, warmup_steps=2, total_steps=6, weight_decay=0.1,
                  grad_clip=1.0)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_optim.init_opt_state(ref_p)
    mine = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    state = init_opt_state(mine)
    for step in range(5):
        # scaled so that clipping acts on some steps and not on others
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * (0.1 + step)).astype(
                np.float32), params)
        ref_p, ref_s, ref_m = ref_optim.apply_updates(
            ref_p, jax.tree.map(jnp.asarray, grads), ref_s,
            ref_optim.OptConfig(**cfg_kw))
        mine, state, metrics = apply_updates(
            mine, tree_map(torch.from_numpy, grads), state,
            OptConfig(**cfg_kw))
        assert int(state["step"]) == int(ref_s["step"]) == step + 1
        assert _rel(float(metrics["grad_norm"]), float(ref_m["grad_norm"])) \
            <= 1e-6
        assert _rel(metrics["lr"], float(ref_m["lr"])) <= 1e-6
        for tree, ref_tree in ((mine, ref_p), (state["m"], ref_s["m"]),
                               (state["v"], ref_s["v"])):
            for got, want in zip(tree_leaves(tree), jax.tree.leaves(ref_tree)):
                assert _rel(got.numpy(), want) <= 1e-6


def test_adamw_slices_a_large_leaf(monkeypatch):
    """The in-place update over slices equals the update in one piece, up
    to the order of the norm's f32 sums."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(3)
    p = rng.normal(size=(40, 9)).astype(np.float32)
    g = rng.normal(size=(40, 9)).astype(np.float32)
    out = []
    for sl in (1 << 26, 17):
        monkeypatch.setattr(adamw, "SLICE", sl)
        params = {"w": torch.from_numpy(p.copy())}
        state = init_opt_state(params)
        for _ in range(3):
            apply_updates(params, {"w": torch.from_numpy(g)}, state,
                          OptConfig(warmup_steps=1))
        out.append((params["w"], state["m"]["w"], state["v"]["w"]))
    for a, b in zip(*out):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6


# ---------------------------------------------------------------- trainer
def _pipe_cfg(cls, cfg):
    return cls(cfg.vocab_size, 4, 32, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference(arch):
    """Five steps from one tree (at the trained scale: at the init's own
    scale Adam's sign-like first steps carry the f32 noise of the
    gradients, 2.3e-4 relative by step 5 on phi4's config, into the
    losses of both packages)."""
    cfg = get_smoke_config(arch)
    jp = _trained_scale(_ref_params(arch))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=40)
    ref = RefTrainer(RefModel(ref_smoke(arch)), ref_optim.OptConfig(**opt),
                     RefTokenPipeline(_pipe_cfg(RefPipelineConfig, cfg)))
    ref.params = jax.tree.map(jnp.asarray, jp)
    ref.opt_state = ref_optim.init_opt_state(ref.params)
    want = ref.run(5).losses
    mine = Trainer(Model(cfg), OptConfig(**opt),
                   TokenPipeline(_pipe_cfg(PipelineConfig, cfg)),
                   params=params_from_jax(jp, device="cpu"))
    got = mine.run(5).losses
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b)


def test_launcher_matches_reference(tmp_path, monkeypatch):
    """`launch.train --smoke` prints the reference launcher's lines, its
    losses within 1e-4 relative (plus the print's rounding), both
    launchers starting from the reference's init at the trained scale."""
    argv = ["--arch", "phi4_mini_3p8b", "--smoke", "--steps", "5",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2"]
    params = params_from_jax(_trained_scale(_ref_params("phi4_mini_3p8b")),
                             device="cpu")
    init = RefModel.init
    monkeypatch.setattr(RefModel, "init", lambda self, key, dtype: (
        jax.tree.map(jnp.asarray, _trained_scale(jax.tree.map(
            np.asarray, init(self, key, dtype))))))
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "ref")])
    ref_out = io.StringIO()
    with redirect_stdout(ref_out):
        ref_launcher.main()
    args = launcher.build_parser().parse_args(argv + [
        "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = io.StringIO()
    with redirect_stdout(out):
        _, res = launcher.train(get_smoke_config("phi4_mini_3p8b"), args,
                                params=params)
    want, got = ref_out.getvalue().splitlines(), out.getvalue().splitlines()
    assert got[0] == want[0]
    head, losses = want[1].split(" loss=")
    assert got[1].split(" loss=")[0] == head == "done: steps=5 restarts=0"
    first, last = (float(x) for x in losses.split("->"))
    for mine, theirs in ((res.losses[0], first), (res.losses[-1], last)):
        assert abs(mine - theirs) <= 1e-4 * abs(theirs) + 5e-4
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))


def test_launcher_refuses_the_mesh_and_a_missing_card(monkeypatch):
    # the production meshes need 256 (512) launched ranks; this process is
    # a world of one (no torchrun or Slurm variables)
    for var in ("RANK", "WORLD_SIZE", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(var, raising=False)
    for flag, need in (("--production-mesh", 256), ("--multi-pod", 512)):
        args = launcher.build_parser().parse_args(
            ["--arch", "gemma2_9b", "--smoke", flag, "--device", "cpu"])
        with pytest.raises(ValueError, match=f"{need} ranks.*has 1"):
            launcher.train(get_smoke_config("gemma2_9b"), args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "gemma2_9b", "--smoke", "--steps", "1"])


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (97, 8, 16, 3), (128, 4, 32, 1), (256000, 2, 64, 0)])
def test_pipeline_matches_reference(vocab, batch, seq, seed):
    for hosts in (1, 2, 4):
        if batch % hosts:
            continue
        for h in range(hosts):
            ref = RefTokenPipeline(RefPipelineConfig(vocab, batch, seq, seed),
                                   num_hosts=hosts, host_id=h)
            mine = TokenPipeline(PipelineConfig(vocab, batch, seq, seed),
                                 num_hosts=hosts, host_id=h)
            for step in (0, 5, 1000):
                want, got = ref.batch_at(step), mine.batch_at(step)
                assert want.keys() == got.keys()
                for key in want:
                    assert got[key].dtype == want[key].dtype
                    assert np.array_equal(got[key], want[key])


# ------------------------------------------------------------- checkpoint
def _tree_np(rng):
    return {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(np.float32),
                  "h": rng.normal(size=(3, 2)).astype(np.float32)},
            "step": np.int32(7)}


def test_checkpoint_jax_saved_restores_in_port(tmp_path):
    tree = _tree_np(np.random.default_rng(4))
    ref_tree = {"a": jnp.asarray(tree["a"]),
                "b": {"c": jnp.asarray(tree["b"]["c"], jnp.bfloat16),
                      "h": jnp.asarray(tree["b"]["h"])},
                "step": jnp.int32(7)}
    RefCheckpointManager(str(tmp_path)).save(3, ref_tree)
    template = {"a": torch.zeros(2, 3), "b": {
        "c": torch.zeros(4, dtype=torch.bfloat16), "h": torch.zeros(3, 2)},
        "step": torch.zeros((), dtype=torch.int32)}
    got, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 3
    assert got["b"]["c"].dtype == torch.bfloat16
    for g, w in zip(tree_leaves(got), jax.tree.leaves(ref_tree)):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w).astype(np.float32))


def test_checkpoint_port_saved_restores_in_jax(tmp_path):
    tree = _tree_np(np.random.default_rng(5))
    mine = tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)
    mine["b"]["c"] = mine["b"]["c"].bfloat16()
    CheckpointManager(str(tmp_path)).save(9, mine, metadata={"note": "x"})
    template = jax.tree.map(jnp.asarray, tree)
    template["b"]["c"] = template["b"]["c"].astype(jnp.bfloat16)
    got, meta = RefCheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 9 and meta["note"] == "x"
    assert got["b"]["c"].dtype == jnp.bfloat16
    for g, w in zip(jax.tree.leaves(got), tree_leaves(mine)):
        assert np.array_equal(np.asarray(g).astype(np.float32),
                              w.float().numpy())


def test_trainer_state_restores_across_packages(tmp_path):
    """A JAX trainer's checkpoint (params and AdamW state after 3 steps)
    is the port trainer's starting state, and the port continues it as
    the reference does."""
    arch = "phi4_mini_3p8b"
    cfg = get_smoke_config(arch)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=40)
    ref = RefTrainer(RefModel(ref_smoke(arch)), ref_optim.OptConfig(**opt),
                     RefTokenPipeline(_pipe_cfg(RefPipelineConfig, cfg)),
                     ckpt=RefCheckpointManager(str(tmp_path / "ref")))
    ref.run(3, ckpt_every=3)
    mine = Trainer(Model(cfg), OptConfig(**opt),
                   TokenPipeline(_pipe_cfg(PipelineConfig, cfg)),
                   ckpt=CheckpointManager(str(tmp_path / "ref")),
                   device="cpu")
    assert mine.step == 3 and int(mine.opt_state["step"]) == 3
    for got, want in zip(tree_leaves({"p": mine.params, "o": {
            "m": mine.opt_state["m"], "v": mine.opt_state["v"]}}),
            jax.tree.leaves({"p": ref.params, "o": {
                "m": ref.opt_state["m"], "v": ref.opt_state["v"]}})):
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
    want = ref.run(2).losses
    got = mine.run(2).losses
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b)


def test_async_save_is_not_torn(tmp_path):
    """`save` copies to the host before it returns: an in-place update
    right after an async save does not reach the checkpoint."""
    params = {"w": torch.arange(1 << 18, dtype=torch.float32)}
    want = params["w"].clone()
    ck = CheckpointManager(str(tmp_path), async_save=True)
    ck.save(1, params)
    params["w"].mul_(-1.0)  # the next step's in-place update
    ck.wait()
    got, _ = ck.restore({"w": torch.zeros(1 << 18)})
    assert torch.equal(got["w"], want)


# ---------------------------------------------------------- compression
REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim import compressed_psum
    z = dict(np.load(sys.argv[1]))
    out = {}
    for key, x in z.items():
        d = x.shape[0]
        mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
        f = shard_map(lambda t: compressed_psum(t, "d"), mesh=mesh,
                      in_specs=P("d"), out_specs=P("d"))
        out[key] = np.asarray(jax.jit(f)(x))
    np.savez(sys.argv[2], **out)
""")
PORT_PSUM = textwrap.dedent("""
    import sys
    sys.path.insert(0, "src")
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.launch.cluster import init_cluster
    from repro_torch.optim import compressed_psum
    rank, d = init_cluster(device="cpu")
    out = {}
    with np.load(sys.argv[1]) as z:
        for key in z.files:
            if z[key].shape[0] == d:
                x = torch.from_numpy(z[key][rank:rank + 1])
                out[key] = compressed_psum(x).numpy()
    np.savez(f"{sys.argv[2]}.rank{rank}.npz", **out)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env.pop("XLA_FLAGS", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_compressed_psum_matches_reference(tmp_path):
    """Groups of 2 and 4 gloo ranks against the reference's mean over as
    many fake CPU devices (its ``shard_map`` test's input, plus one whose
    length the group does not divide): within one int8 step of the
    inputs, and both within the reference test's bound of the exact
    mean."""
    rng = np.random.default_rng(0)
    inputs = {f"d{d}_{name}": rng.normal(size=(d,) + shape).astype(
        np.float32) for d in (2, 4) for name, shape in
        (("square", (1, 64)), ("odd", (1, 3, 7)))}
    np.savez(tmp_path / "in.npz", **inputs)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_PSUM, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npz")], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = []
    for d in (2, 4):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", PORT_PSUM, str(tmp_path / "in.npz"),
             str(tmp_path / f"d{d}")], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(RANK=r, WORLD_SIZE=d, LOCAL_RANK=r, LOCAL_WORLD_SIZE=d,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
            for r in range(d)]
    for p in procs + [ref]:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err
    want = np.load(tmp_path / "ref.npz")
    for key, x in inputs.items():
        d = x.shape[0]
        step = float(np.abs(x).max()) / 127
        exact = x.mean(axis=0)
        for r in range(d):
            got = np.load(tmp_path / f"d{d}.rank{r}.npz")[key][0]
            assert got.shape == exact.shape
            assert float(np.abs(got - want[key][r]).max()) <= step
            assert float(np.abs(got - exact).max()) < 3 * step
            assert float(np.abs(want[key][r] - exact).max()) < 3 * step


# ------------------------------------------- the cases of test_runtime.py
def test_adamw_minimizes_quadratic():
    target = torch.from_numpy(
        np.random.default_rng(0).normal(size=(32,)).astype(np.float32))
    params = {"w": torch.zeros(32, requires_grad=True)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.05, warmup_steps=5, total_steps=200,
                    weight_decay=0.0)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)
    for _ in range(200):
        (g,) = torch.autograd.grad(loss(params), [params["w"]])
        params, state, _ = apply_updates(params, {"w": g}, state, cfg)
    assert float(loss(params)) < 1e-2


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1)
    lrs = [schedule_lr(cfg, s) for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0          # warmup
    assert abs(lrs[10] - 1.0) < 0.01       # peak
    assert lrs[100] == pytest.approx(0.1, rel=0.05)  # cosine floor
    ref = ref_optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    for s in range(101):
        want = float(ref_optim.schedule_lr(ref, jnp.int32(s)))
        assert abs(lrs[s] - want) <= 1e-6 * max(abs(want), 1e-30)


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=4,
                max_size=64))
def test_quantize_bounded_error(xs):
    x = torch.tensor(np.array(xs, np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_reference(seed):
    x = (np.random.default_rng(seed).normal(size=97) * 10 ** seed).astype(
        np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_optim.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_error_feedback_unbiased_accumulation():
    """With EF, the *accumulated* applied update tracks the accumulated
    gradient (compression bias does not accumulate)."""
    rng = np.random.default_rng(0)
    g_total = np.zeros(64, np.float32)
    applied = np.zeros(64, np.float32)
    err = torch.zeros(64)
    for _ in range(200):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        q, s, err = ef_compress(g, err)
        applied += dequantize_int8(q, s).numpy()
        g_total += g.numpy()
    assert np.abs(applied - g_total).max() <= float(err.max()) + np.abs(
        err.numpy()).max() + 1.0


def test_checkpoint_roundtrip_and_keep():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        for s in (10, 20, 30):
            ck.save(s, tree)
        assert ck.all_steps() == [20, 30]
        restored, meta = ck.restore(tree)
        assert meta["step"] == 30
        assert torch.equal(restored["a"], tree["a"])
        assert restored["b"]["c"].dtype == torch.bfloat16


def test_checkpoint_atomicity_no_partial_dirs():
    tree = {"a": torch.zeros(1000, 100)}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=5, async_save=True)
        ck.save(1, tree)
        ck.wait()
        names = os.listdir(d)
        assert all(n.startswith("step_") for n in names), names


def test_restore_onto_another_device():
    """``device`` takes the place of the reference's shardings: the
    arrays land there, whatever the template's device."""
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, {"x": x})
        restored, _ = ck.restore({"x": torch.empty(8, 8, device="meta")},
                                 device="cpu")
        assert restored["x"].device.type == "cpu"
        assert torch.equal(restored["x"], x)


def test_trainer_converges_and_recovers_from_fault():
    cfg = get_smoke_config("phi4_mini_3p8b")
    pipe = TokenPipeline(PipelineConfig(cfg.vocab_size, 4, 32, seed=1))
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        tr = Trainer(Model(cfg), OptConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=40),
                     pipe, ckpt=ck, device="cpu")
        res = tr.run(20, ckpt_every=5)
        assert res.losses[-1] < res.losses[0]
        fired = {}

        def inject(step):
            if step == 23 and not fired:
                fired["x"] = 1
                raise RuntimeError("simulated preemption")
        res2 = tr.run(8, ckpt_every=4, fault_injector=inject)
        assert res2.restarts == 1
        assert res2.steps_done == 8


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(zscore=3.0, warmup=3)
    for i in range(20):
        mon.observe(i, 0.10 + 0.001 * (i % 3))
    assert mon.observe(99, 1.0)  # 10x step time flagged
    assert mon.events and mon.events[-1][0] == 99
