"""The port's sharded train step (`repro_torch.train.make_train_step` over a
4x2 ``(data, model)`` `DeviceMesh` of 8 gloo ranks on the CPU) against the
JAX package's (`repro.train.make_train_step` over a 4x2 mesh of 8 fake CPU
devices, as `tests/test_distributed.py::
test_sharded_train_step_matches_single_device` runs it), and the elastic
restore of a sharded checkpoint onto another mesh (the counterpart of
`tests/test_runtime.py::test_elastic_restore_onto_different_mesh`).

Both packages start from the reference's parameters (`Model.init` with
`PRNGKey(0)`, gemma2's smoke config, f32, each weight matrix rescaled to
std 1/sqrt(d_in) as the train parities take it) and one batch of 8 x 32
tokens from `numpy.random.default_rng(0)`.  The gradients that reach
AdamW are compared as well as the step's result: at step 1 Adam's
update is about lr times the gradient's sign, so the leaves alone could
not show a wrong gradient.  The reference runs in one subprocess;
the port in 8 ``python -c`` ranks started with torchrun's variables, each
through `launch.cluster.init_cluster`; rank 0 writes the gathered results.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

REF_SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.models.model import Model
    from repro.optim import OptConfig, init_opt_state
    from repro.train import make_train_step
    from repro.launch import mesh as meshlib

    def flat(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out.update(flat(tree[k], f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(tree[k])
        return out

    def trained_scale(path, a):  # each weight matrix at std 1/sqrt(d_in)
        if path[-1].key == "w":
            return a * np.float32(np.sqrt(a.shape[0] / a.shape[-2]))
        return a

    cfg = get_smoke_config("gemma2_9b")
    m = Model(cfg)
    params = jax.tree_util.tree_map_with_path(
        trained_scale, m.init(jax.random.PRNGKey(0), jnp.float32))
    opt = init_opt_state(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32))}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s1 = make_train_step(m, OptConfig(), mesh=None, donate=False)
    p1, _, met1 = s1(params, opt, jb)
    g1 = jax.jit(jax.grad(m.loss_fn))(params, jb)
    mesh = meshlib.make_mesh((4, 2), ("data", "model"))
    s2 = make_train_step(m, OptConfig(), mesh=mesh, donate=False)
    p2, _, met2 = s2(params, opt, jb)

    def sharded_grad(p, b):
        with meshlib.sharding_context(mesh, meshlib.DEFAULT_RULES):
            return jax.grad(m.loss_fn)(p, b)
    g2 = jax.jit(sharded_grad)(params, jb)
    out = {**{"init/" + k: v for k, v in flat(params).items()},
           **{"single/" + k: v for k, v in flat(p1).items()},
           **{"sharded/" + k: v for k, v in flat(p2).items()},
           **{"grad_single/" + k: v for k, v in flat(g1).items()},
           **{"grad_sharded/" + k: v for k, v in flat(g2).items()},
           **{"batch/" + k: v for k, v in batch.items()},
           "loss": np.array([float(met1["loss"]), float(met2["loss"])]),
           "grad_norm": np.array([float(met1["grad_norm"]),
                                  float(met2["grad_norm"])])}
    np.savez(sys.argv[1], **out)
''')

PORT_SCRIPT = textwrap.dedent('''
    import contextlib, json, sys
    sys.path[:0] = ["src", "."]
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, Shard
    from chip_smoke import staged_collectives
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.cluster import init_cluster
    from repro_torch.models import flash_xla
    from repro_torch.models.model import Model
    from repro_torch.models.params import params_from_jax
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import trainer as trainer_mod

    ref_path, out_dir = sys.argv[1], sys.argv[2]
    rank, world = init_cluster(device="cpu")
    z = np.load(ref_path)

    def tree(prefix):
        out = {}
        for name in z.files:
            if name.startswith(prefix):
                node, *keys = out, *name[len(prefix):].split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = z[name]
        return out

    def flat(t, prefix=""):
        out = {}
        for k in sorted(t):
            if isinstance(t[k], dict):
                out.update(flat(t[k], f"{prefix}{k}/"))
            else:
                out[prefix + k] = t[k]
        return out

    def names(placements):  # S<dim>, R, P: the same on every torch
        return [f"S{p.dim}" if isinstance(p, Shard) else
                "R" if isinstance(p, Replicate) else "P"
                for p in placements]

    cfg = get_smoke_config("gemma2_9b")
    mesh = meshlib.make_mesh((4, 2), ("data", "model"), device_type="cpu")
    rules = meshlib.DEFAULT_RULES

    def one_step(staged, mesh=mesh):
        """One sharded step from the reference's init: (loss, grad norm,
        new leaves, the gradients AdamW got, their placements beside the
        weights') gathered whole; with ``staged``, DTensor's collectives
        run as c10d calls (chip_smoke.staged_collectives, the form gloo
        ranks sharing a card take), forced here on CPU tensors."""
        batch = {k: meshlib.distribute(
            torch.from_numpy(z["batch/" + k]), mesh, meshlib.sharding_for(
                ("act_batch", "act_seq"), (8, 32), mesh, rules))
            for k in ("tokens", "labels")}
        model = Model(cfg)
        model.load(meshlib.distribute_tree(
            params_from_jax(tree("init/"), device="cpu"), model.param_axes(),
            mesh, rules), trainable=True)
        grads, placed, pin = [], [], trainer_mod.pin

        def seen_pin(g, w):
            out = pin(g, w)
            grads.append(out)
            placed.append((names(out.placements), names(w.placements)))
            return out
        trainer_mod.pin = seen_pin
        ctx = (staged_collectives(mesh, devices=("cpu",)) if staged
               else contextlib.nullcontext())
        try:
            with ctx:
                params, _, met = trainer_mod.make_train_step(
                    model, OptConfig(), mesh, rules)(
                    model.params, init_opt_state(model.params), batch)
                full = {k: v.detach().full_tensor().numpy()
                        for k, v in flat(params).items()}
                grad = {k: g.full_tensor().numpy()
                        for k, g in zip(full, grads)}
        finally:
            trainer_mod.pin = pin
        return (float(met["loss"]), float(met["grad_norm"]), full, grad,
                placed, {k: names(v.placements)
                         for k, v in flat(params).items()})

    # record what the attention kernels see
    heads, apply = [], flash_xla.FlashAttention.apply
    flash_xla.FlashAttention.apply = lambda q, k, v, *a: (
        heads.append((q.shape[2], k.shape[2], type(q).__name__))
        or apply(q, k, v, *a))
    loss, gnorm, full, grad, placed, leaf_placements = one_step(False)
    flash_xla.FlashAttention.apply = apply
    s_loss, s_gnorm, s_full, s_grad, _, _ = one_step(True)
    staged_err = max(float(np.abs(s_full[k] - full[k]).max()) for k in full)
    staged_grad_err = max(float(np.abs(s_grad[k] - grad[k]).max()
                                / max(np.abs(grad[k]).max(), 1e-30))
                          for k in grad)
    # a 2x4 mesh: 2 kv heads do not divide the 4-way model axis, so each
    # rank attends with the one kv head its q head reads and its dk/dv
    # come back Partial (the production mesh's GQA case)
    m24 = meshlib.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    heads24 = []
    flash_xla.FlashAttention.apply = lambda q, k, v, *a: (
        heads24.append((q.shape[2], k.shape[2], type(q).__name__))
        or apply(q, k, v, *a))
    loss24, gnorm24, _, grad24, placed24, _ = one_step(False, m24)
    flash_xla.FlashAttention.apply = apply
    info = {"loss": loss, "grad_norm": gnorm, "heads": heads,
            "loss24": loss24, "grad_norm24": gnorm24, "heads24": heads24,
            "placed24": placed24,
            "placed": placed, "staged_loss": s_loss,
            "staged_grad_norm": s_gnorm, "staged_err": staged_err,
            "staged_grad_err": staged_grad_err,
            "leaf_placements": leaf_placements}

    # the Trainer's own init under the mesh: each leaf drawn whole, its
    # shard kept before the next is drawn
    tr = trainer_mod.Trainer(Model(cfg), OptConfig(), None, mesh=mesh,
                             device="cpu")
    want = flat(Model(cfg).init(0, torch.float32, "cpu").params)
    local = [v.to_local() for v in flat(tr.params).values()]
    info["trainer_init"] = {
        "equal": all(torch.equal(v.full_tensor(), want[k])
                     for k, v in flat(tr.params).items()),
        "sharded": sum(any(isinstance(p, Shard) for p in v.placements)
                       for v in flat(tr.params).values()),
        "own_storage": all(t.untyped_storage().nbytes()
                           == t.numel() * t.element_size() for t in local)}

    # elastic restore: x sharded over 8 ranks, saved, restored onto 2x4
    m8 = meshlib.make_mesh((8,), ("data",), device_type="cpu")
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ck = CheckpointManager(out_dir + "/ckpt")
    ck.save(1, {"x": meshlib.distribute(x, m8, (Shard(0),))})
    dist.barrier()
    restored, _ = ck.restore({"x": x}, mesh=m24,
                             placements={"x": (Shard(0), Shard(1))})
    r = restored["x"]
    info["restore"] = {
        "equal": bool(torch.equal(r.full_tensor(), x)),
        "mesh": dict(zip(r.device_mesh.mesh_dim_names,
                         r.device_mesh.shape)),
        "placements": names(r.placements),
        "local": list(r.to_local().shape)}
    if rank == 0:
        np.savez(out_dir + "/port.npz", **full,
                 **{"grad/" + k: v for k, v in grad.items()},
                 **{"grad24/" + k: v for k, v in grad24.items()})
        with open(out_dir + "/port.json", "w") as f:
            json.dump(info, f)
    dist.barrier()
    dist.destroy_process_group()
''')


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
def runs(tmp_path_factory):
    """(reference npz, port npz, port info) of one step each."""
    import json
    tmp = tmp_path_factory.mktemp("sharded")
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          str(tmp / "ref.npz")], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT_SCRIPT, str(tmp / "ref.npz"), str(tmp)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(RANK=r, WORLD_SIZE=8, LOCAL_RANK=r, LOCAL_WORLD_SIZE=8,
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(8)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out + err
    with open(tmp / "port.json") as f:
        info = json.load(f)
    return np.load(tmp / "ref.npz"), np.load(tmp / "port.npz"), info, tmp


def test_sharded_step_matches_reference(runs):
    """One 4x2 step: the loss and every leaf within 1e-4 of the
    reference's sharded step, and of its single-device step.  (At step 1
    AdamW moves a leaf by about lr = 3e-6 whatever the gradient, so this
    checks the forward and the update's form; the gradients are held
    below.)"""
    ref, port, info, _ = runs
    single, sharded = ref["loss"]
    assert abs(info["loss"] - sharded) < 1e-4
    assert abs(info["loss"] - single) < 1e-4
    names = sorted(n[len("sharded/"):] for n in ref.files
                   if n.startswith("sharded/"))
    assert sorted(f for f in port.files if not f.startswith("grad")) \
        == names
    for name in names:
        for which in ("sharded/", "single/"):
            d = float(np.abs(port[name] - ref[which + name]).max())
            assert d < 1e-4, (which, name, d)


def test_sharded_step_gradients_match_reference(runs):
    """The gradients the sharded step hands AdamW (gathered whole): each
    leaf within 1e-4 of its max |g| of the reference's gradient under the
    4x2 mesh, and of its single-device gradient; the step's grad norm
    within 1e-4 of both reference steps' (relative)."""
    ref, port, info, _ = runs
    names = sorted(n[len("grad_sharded/"):] for n in ref.files
                   if n.startswith("grad_sharded/"))
    assert sorted(f[len("grad/"):] for f in port.files
                  if f.startswith("grad/")) == names
    for name in names:
        got = port["grad/" + name].astype(np.float64)
        for which in ("grad_sharded/", "grad_single/"):
            want = ref[which + name].astype(np.float64)
            scale = np.abs(want).max()
            assert scale > 0, (which, name)
            err = float(np.abs(got - want).max() / scale)
            assert err < 1e-4, (which, name, err)
    for want in ref["grad_norm"]:
        assert abs(info["grad_norm"] - want) / want < 1e-4, (
            info["grad_norm"], ref["grad_norm"])


def test_gqa_sharded_step_gradients_match_reference(runs):
    """The step over a 2x4 mesh, where 2 kv heads do not divide the 4-way
    model axis (each rank attends with the one kv head its q head reads,
    dk/dv come back as a Partial sum, reduced where the gradient is
    pinned): loss within 1e-4 of the reference's single-device step,
    each leaf's gradient within 1e-4 of its max |g|, grad norm within
    1e-4 (relative); every gradient in its weight's placements; one q
    head and one kv head a rank."""
    ref, port, info, _ = runs
    assert abs(info["loss24"] - ref["loss"][0]) < 1e-4
    names = sorted(n[len("grad_single/"):] for n in ref.files
                   if n.startswith("grad_single/"))
    assert sorted(f[len("grad24/"):] for f in port.files
                  if f.startswith("grad24/")) == names
    for name in names:
        want = ref["grad_single/" + name].astype(np.float64)
        err = float(np.abs(port["grad24/" + name] - want).max()
                    / np.abs(want).max())
        assert err < 1e-4, (name, err)
    assert abs(info["grad_norm24"] - ref["grad_norm"][0]) \
        / ref["grad_norm"][0] < 1e-4
    assert all(g == w for g, w in info["placed24"])
    assert {tuple(h) for h in info["heads24"]} == {(1, 1, "Tensor")}


def test_sharded_step_pins_gradients_to_the_weights(runs):
    """Every gradient reaches AdamW in its weight's placements, and the
    updated parameters keep the placements the rules give them."""
    _, _, info, _ = runs
    assert len(info["placed"]) == len(info["leaf_placements"])
    assert all(g == w for g, w in info["placed"])
    lp = info["leaf_placements"]
    # gemma2 smoke: embed [128, 64] (vocab -> model, embed -> data)
    assert lp["embed"] == ["S1", "S0"]
    # stacked wq [2, 64, 64]: (layers, embed, qkv)
    assert lp["groups/0/attn/wq/w"] == ["S1", "S2"]
    assert lp["final_norm"] == ["R", "R"]


def test_sharded_step_attends_on_local_heads(runs):
    """The attention kernels' wrapper gets each rank's local shards as
    plain tensors: 4 q heads and 2 kv heads over a 2-way model axis give
    2 q heads and 1 kv head a rank, in each layer's forward, remat
    recomputations included."""
    _, _, info, _ = runs
    assert info["heads"]
    assert {tuple(h) for h in info["heads"]} == {(2, 1, "Tensor")}


def test_elastic_restore_onto_different_mesh(runs):
    """A checkpoint saved from 8 ranks' shards (an 8-way data mesh)
    restores onto a 2x4 mesh with each rank holding its [4, 2] block, and
    the JAX package's manager reads the same file."""
    from repro.checkpoint import CheckpointManager as RefManager
    _, _, info, tmp = runs
    rest = info["restore"]
    assert rest["equal"]
    assert rest["mesh"] == {"data": 2, "model": 4}
    assert rest["placements"] == ["S0", "S1"]
    assert rest["local"] == [4, 2]
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    restored, meta = RefManager(str(tmp / "ckpt")).restore({"x": x})
    np.testing.assert_array_equal(np.asarray(restored["x"]), x)
    assert meta["step"] == 1


def test_staged_collectives_give_the_same_step(runs):
    """The step with DTensor's functional collectives run as c10d calls
    (`chip_smoke.staged_collectives`, how gloo ranks sharing a card
    communicate) equals the step through the functional collectives:
    loss, grad norm, leaves and gradients."""
    _, _, info, _ = runs
    assert abs(info["staged_loss"] - info["loss"]) < 1e-6
    assert abs(info["staged_grad_norm"] - info["grad_norm"]) < 1e-6
    assert info["staged_err"] < 1e-6
    assert info["staged_grad_err"] < 1e-6


def test_trainer_draws_each_leaf_then_keeps_its_shard(runs):
    """`Trainer(mesh=...)` without ``params`` draws the one-device init
    from the seed, leaf by leaf, each rank keeping only its shard: the
    gathered parameters equal `Model.init`'s on one device, and every
    sharded leaf's local tensor owns just its own storage."""
    _, _, info, _ = runs
    init = info["trainer_init"]
    assert init["equal"]
    assert init["sharded"] > 0
    assert init["own_storage"]
