"""The port's mixture-of-experts block (`repro_torch.models.moe`) against the
JAX package's (`repro.models.moe`), in f32 on the CPU route, with the same
parameters (drawn by the reference's `init_params`, handed over as numpy)
and numpy-seeded inputs:

- `moe_specs` (shapes and logical axes), `capacity_for`, the moe block's
  specs and cache;
- `_apply_moe_dense` against the reference's and against the per-token
  oracle of `tests/test_models.py::test_moe_matches_per_token_oracle`,
  values and gradients within 2e-4;
- the capacity drops of `test_moe_capacity_drops_tokens`: the same rows
  dropped as the reference drops, and the drop count;
- ties in the router's top-k, which both break toward the lower expert;
- `model_flops` with the inactive routed experts subtracted;
- `_apply_moe_a2a` over gloo ranks on `launch.mesh` meshes, (2, 2) data x
  model and (2, 2, 2) pod x data x model, against the dense route: values
  within 2e-4, gradients within 2e-3 (the bar of
  `tests/test_distributed.py::test_moe_a2a_matches_dense_dispatch`).  The
  ranks are ``python -c`` processes started with torchrun's variables, as
  `tests/test_torch_sharded_train.py` starts its 8.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import blocks as ref_blocks
from repro.models import config as ref_cfgmod
from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.model import model_flops as ref_model_flops
from repro.models.params import init_params as ref_init

torch = pytest.importorskip("torch")
from repro_torch import configs  # noqa: E402
from repro_torch.models import blocks, moe  # noqa: E402
from repro_torch.models import config as cfgmod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import Model, model_flops  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from test_torch_train import _trained_scale  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["llama4_scout_17b_16e", "deepseek_v2_lite_16b"]
# the reference's MoE test layer (`tests/test_models.py`,
# `tests/test_distributed.py`): 4 experts, top-2, ample capacity
ORACLE = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, d_ff=24, vocab_size=32, num_experts=4,
              moe_top_k=2, capacity_factor=8.0)
# `test_moe_capacity_drops_tokens`' layer: 2 experts, top-1, capacity 128
# for 512 tokens
DROPS = dict(name="t", family="moe", num_layers=1, d_model=8, num_heads=1,
             num_kv_heads=1, d_ff=8, vocab_size=8, num_experts=2,
             moe_top_k=1, capacity_factor=0.01)


def _configs(name):
    """(the port's config, the reference's) of a named test layer: the
    oracle's or the drop case's, or an architecture's smoke layer."""
    if name in MOE_ARCHS:
        return configs.get_smoke_config(name), ref_smoke(name)
    kw = {"oracle": ORACLE, "drops": DROPS}[name]
    return ModelConfig(**kw), RefModelConfig(**kw)


def _params(rcfg, seed=0, trained=False):
    """The reference's `init_params` of an moe block, as numpy; with
    ``trained``, each weight matrix rescaled to std 1/sqrt(d_in)
    (`test_torch_train._trained_scale`: the init draws an expert's [E,
    d_in, d_out] at 1/sqrt(E), which puts a smoke layer's outputs near 10
    and f32 rounding, not the port, at a 2e-4 bar)."""
    p = jax.tree.map(np.asarray, ref_init(ref_moe.moe_specs(rcfg),
                                          jax.random.PRNGKey(seed)))
    return _trained_scale(p) if trained else p


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _dense_grads(p, x, cfg):
    """(y, gradients of sum(tanh(y)) by every leaf of p, then by x) of the
    port's dense route."""
    tp = tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    y = moe._apply_moe_dense(tp, tx, cfg)
    leaves = []
    tree_map(leaves.append, tp)
    grads = torch.autograd.grad(torch.tanh(y).sum(), leaves + [tx])
    return y.detach().numpy(), [g.numpy() for g in grads]


def _ref_grads(p, x, rcfg):
    def f(p, x):
        return jnp.sum(jnp.tanh(ref_moe._apply_moe_dense(p, x, rcfg)))
    jp = jax.tree.map(jnp.asarray, p)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x))
    return [np.asarray(g) for g in jax.tree.leaves(gp)] + [np.asarray(gx)]


@pytest.mark.parametrize("name", ["oracle"] + MOE_ARCHS)
def test_moe_specs_match_reference(name):
    cfg, rcfg = _configs(name)
    want = jax.tree.map(lambda s: (s.shape, s.axes), ref_moe.moe_specs(rcfg),
                        is_leaf=lambda s: hasattr(s, "axes"))
    got = tree_map(lambda s: (s.shape, s.axes), moe.moe_specs(cfg))
    assert got == want
    if name in MOE_ARCHS:
        shared = got["shared"]["down"]["w"][0]
        assert shared == (cfg.d_ff * cfg.num_shared_experts, cfg.d_model)
        want = jax.tree.map(lambda s: s.shape, ref_blocks.block_specs(
            rcfg, "moe"), is_leaf=lambda s: hasattr(s, "axes"))
        assert tree_map(lambda s: s.shape,
                        blocks.block_specs(cfg, "moe")) == want
        cache = blocks.cache_struct(cfg, "moe", 2, 8, torch.float32, "cpu")
        rcache = ref_blocks.cache_struct(rcfg, "moe", 2, 8, jnp.float32)
        assert tree_map(lambda t: tuple(t.shape), cache) == jax.tree.map(
            lambda a: tuple(a.shape), rcache)


@pytest.mark.parametrize("tokens", [1, 8, 100, 512, 4096, 100_000])
def test_capacity_for_matches_reference(tokens):
    for name in ["oracle", "drops"] + MOE_ARCHS:
        cfg, rcfg = _configs(name)
        assert moe.capacity_for(tokens, cfg) == ref_moe.capacity_for(
            tokens, rcfg)
    for arch in MOE_ARCHS:
        assert moe.capacity_for(tokens, configs.get_config(arch)) == \
            ref_moe.capacity_for(tokens, ref_config(arch))


@pytest.mark.parametrize("name", ["oracle"] + MOE_ARCHS)
def test_dense_matches_reference(name):
    """Values and the gradients of sum(tanh(y)) by every parameter and by
    x, within 2e-4, on the oracle's layer (the reference's init) and both
    smoke layers (shared experts included; weights at 1/sqrt(d_in))."""
    cfg, rcfg = _configs(name)
    p = _params(rcfg, trained=name in MOE_ARCHS)
    x = np.random.default_rng(0).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    y, grads = _dense_grads(p, x, cfg)
    want = np.asarray(ref_moe._apply_moe_dense(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg))
    np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)
    for g, w in zip(grads, _ref_grads(p, x, rcfg)):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


def test_dense_matches_per_token_oracle():
    """`test_moe_matches_per_token_oracle`'s numpy oracle: each token's
    top-2 experts evaluated directly, gates renormalised."""
    cfg, rcfg = _configs("oracle")
    p = _params(rcfg)
    x = np.random.default_rng(0).normal(size=(2, 8, 16)).astype(np.float32)
    y = moe.apply_moe(_t(p), torch.from_numpy(x), cfg).numpy()
    toks = x.reshape(-1, 16)
    logits = toks @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    topk = np.argsort(-probs, axis=-1)[:, :2]
    expect = np.zeros_like(toks)
    for t in range(toks.shape[0]):
        gsum = probs[t, topk[t]].sum()
        for e in topk[t]:
            g = toks[t] @ p["w_gate"][e]
            u = toks[t] @ p["w_up"][e]
            h = g / (1 + np.exp(-g)) * u
            expect[t] += (probs[t, e] / gsum) * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, 16), expect, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("inputs", ["ones", "normal"])
def test_capacity_drops_the_references_rows(inputs):
    """Capacity 128 for 512 tokens on 2 experts, top-1: the rows the
    reference drops (its zero rows) are the port's, the served rows equal
    within 2e-4, and `moe.dropped` counts the dropped assignments."""
    cfg, rcfg = _configs("drops")
    p = _params(rcfg)
    x = (np.ones((1, 512, 8), np.float32) if inputs == "ones" else
         np.random.default_rng(1).normal(size=(1, 512, 8)).astype(
             np.float32))
    want = np.asarray(ref_moe.apply_moe(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(x), rcfg))[0]
    moe.dropped = torch.zeros((), dtype=torch.int64)
    try:
        y = moe.apply_moe(_t(p), torch.from_numpy(x), cfg).numpy()[0]
        count = int(moe.dropped)
    finally:
        moe.dropped = None
    zero, want_zero = (np.linalg.norm(a, axis=-1) == 0 for a in (y, want))
    assert want_zero.any() and not want_zero.all()
    np.testing.assert_array_equal(zero, want_zero)
    assert count == int(zero.sum())
    np.testing.assert_allclose(y, want, rtol=2e-4, atol=2e-4)


def test_top_k_ties_go_to_the_lower_expert():
    """A router whose columns repeat (experts 0 = 2 and 1 = 3) ties every
    token's probabilities in pairs, so a token's top two are a tied pair:
    `lax.top_k` puts the lower expert of a tie first, and so does the
    port's router; the outputs match."""
    cfg, rcfg = _configs("oracle")
    p = _params(rcfg)
    p["router"] = np.concatenate([p["router"][:, :2]] * 2, axis=1)
    x = np.random.default_rng(2).normal(size=(2, 8, 16)).astype(np.float32)
    tokens = torch.from_numpy(x.reshape(-1, 16))
    _, eidx = moe._route(tokens, torch.from_numpy(p["router"]), 2)
    logits = jnp.asarray(x.reshape(-1, 16)) @ jnp.asarray(p["router"])
    _, want = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(want))
    # each token's top two are a tied pair, the lower expert first
    assert {tuple(r) for r in eidx.numpy()} <= {(0, 2), (1, 3)}
    y = moe.apply_moe(_t(p), torch.from_numpy(x), cfg).numpy()
    want_y = np.asarray(ref_moe.apply_moe(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x), rcfg))
    np.testing.assert_allclose(y, want_y, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_flops_counts_active_experts(arch, shape_name):
    """`model_flops` equals the reference's, and counts top_k of the
    routed experts a layer (plus the shared ones), not all of them."""
    cfg = configs.get_config(arch)
    shape = cfgmod.SHAPES[shape_name]
    got = model_flops(cfg, shape)
    assert got == ref_model_flops(ref_config(arch),
                                  ref_cfgmod.SHAPES[shape_name])
    per_token = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    inactive = ((cfg.num_experts - cfg.moe_top_k) * 3 * cfg.d_model
                * cfg.d_ff * cfg.num_layers)
    assert inactive > 0
    assert got == per_token * (Model(cfg).num_params() - inactive) * tokens


# ------------------------------------------------------------ all-to-all
RANK_SCRIPT = textwrap.dedent('''
    import json, sys
    sys.path[:0] = ["src"]
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.cluster import init_cluster
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.params import param_axes, tree_leaves

    inp, out, shape, cfg_kw = (sys.argv[1], sys.argv[2],
                               tuple(int(a) for a in sys.argv[3].split("x")),
                               json.loads(sys.argv[4]))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    rank, world = init_cluster(device="cpu")
    z = np.load(inp)
    cfg = ModelConfig(**cfg_kw)
    specs = moe.moe_specs(cfg)
    full = {k[2:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith("p/")}
    x = torch.from_numpy(z["x"])
    mesh = meshlib.make_mesh(shape, names, device_type="cpu")
    rules = meshlib.DEFAULT_RULES
    params = meshlib.distribute_tree(full, param_axes(specs), mesh, rules)
    for t in tree_leaves(params):
        t.requires_grad_()
    xd = meshlib.distribute(x, mesh, meshlib.sharding_for(
        ("act_batch", "act_seq", "act_embed"), tuple(x.shape), mesh, rules))
    xd.requires_grad_()
    routes, a2a = [], moe._apply_moe_a2a
    moe._apply_moe_a2a = lambda *a: routes.append("a2a") or a2a(*a)
    with meshlib.sharding_context(mesh, rules):
        y = moe.apply_moe(params, xd, cfg)
    moe._apply_moe_a2a = a2a
    y = y.full_tensor()
    grads = torch.autograd.grad(torch.tanh(y).sum(),
                                tree_leaves(params) + [xd])
    grads = [g.full_tensor() for g in grads]
    if rank == 0:
        np.savez(out, y=y.detach().numpy(), routes=np.array(routes),
                 **{f"g{i}": g.numpy() for i, g in enumerate(grads)})
    dist.barrier()
    dist.destroy_process_group()
''')
A2A_MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update({k: str(v) for k, v in extra.items()})
    return env


@pytest.fixture(scope="module")
def a2a_runs(tmp_path_factory):
    """{mesh: (the a2a's y and gradients, gathered on rank 0)}, with the
    port's and the reference's dense route on the same inputs: the
    reference test's layer and x [8, 8, 16] from `default_rng(0)`."""
    tmp = tmp_path_factory.mktemp("moe_a2a")
    cfg, rcfg = _configs("oracle")
    p = _params(rcfg)
    x = np.random.default_rng(0).normal(size=(8, 8, 16)).astype(np.float32)
    np.savez(tmp / "in.npz", x=x, **{f"p/{k}": v for k, v in p.items()})
    procs = []
    for name, shape in A2A_MESHES.items():
        world, port = int(np.prod(shape)), _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(tmp / "in.npz"),
             str(tmp / f"{name}.npz"), name, json.dumps(ORACLE)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
                                LOCAL_WORLD_SIZE=world,
                                MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
            for r in range(world)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, out + err
    y, grads = _dense_grads(p, x, cfg)
    want = np.asarray(ref_moe._apply_moe_dense(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg))
    dense = {"port": (y, grads), "ref": (want, _ref_grads(p, x, rcfg))}
    return {name: np.load(tmp / f"{name}.npz") for name in A2A_MESHES}, dense


@pytest.mark.parametrize("mesh_name", list(A2A_MESHES))
def test_a2a_values_match_dense(a2a_runs, mesh_name):
    """The a2a route (the one `apply_moe` took on every rank) within 2e-4
    of the port's dense route and of the reference's."""
    runs, dense = a2a_runs
    got = runs[mesh_name]
    assert list(got["routes"]) == ["a2a"]
    for which in ("port", "ref"):
        assert np.abs(got["y"] - dense[which][0]).max() < 2e-4, which


@pytest.mark.parametrize("mesh_name", list(A2A_MESHES))
def test_a2a_gradients_match_dense(a2a_runs, mesh_name):
    """The gradients of sum(tanh(y)) by the router, every expert weight
    and x, gathered whole, within 2e-3 of the dense route's (the port's
    and the reference's)."""
    runs, dense = a2a_runs
    got = runs[mesh_name]
    for which in ("port", "ref"):
        want = dense[which][1]
        assert len(got.files) == len(want) + 2
        for i, w in enumerate(want):
            err = float(np.abs(got[f"g{i}"] - w).max())
            assert err < 2e-3, (which, i, err)
