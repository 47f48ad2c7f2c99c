"""The port's Mamba2 SSD mixer (`repro_torch.models.ssm`) against the JAX
package's (`repro.models.ssm`), on numpy-seeded inputs in f32 on the CPU:
the chunked scan against the reference's and against the direct
recurrence of `tests/test_models.py::test_ssd_chunked_matches_sequential`
(rtol = atol = 2e-4, its tolerance), the scan's gradients against
`jax.grad` (within 1e-4 of each input's largest |g|), the causal conv with
and without a decode state, and `apply_ssm` in all three kinds on the
mamba2 and zamba2 smoke layers (outputs and cache leaves within 1e-4 of
their largest magnitude); then what the slice changed around it: the
remat's attention count, `pad_cache` on the SSM leaves, the train
launcher's mamba2 line, and the loss and gradients of both smoke models
over a 2x2 ``(data, model)`` mesh of 4 gloo ranks against one device."""
import json
import os
import socket
import subprocess
import textwrap
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.models import ssm as ref_ssm

torch = pytest.importorskip("torch")
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import Model, lm, ssm  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _scan_inputs(rng, b=2, l=32, h=3, p=8, n=5):
    """xh, dt, a, b_, c_ of the reference test's shapes and ranges."""
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.1, 0.9, (b, l, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, (h,)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32))


def _sequential(xh, dt, a, b_, c_):
    """The direct recurrence h_t = exp(dt a) h + dt B x_t, y_t = C h_t."""
    bsz, l, h, p = xh.shape
    st = np.zeros((bsz, h, b_.shape[-1], p), np.float32)
    ys = np.zeros_like(xh)
    for t in range(l):
        st = np.exp(dt[:, t] * a)[:, :, None, None] * st + np.einsum(
            "bn,bhp->bhnp", b_[:, t], xh[:, t] * dt[:, t][..., None])
        ys[:, t] = np.einsum("bn,bhnp->bhp", c_[:, t], st)
    return ys, st


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_chunked_matches_reference_and_sequential(chunk):
    args = _scan_inputs(np.random.default_rng(0))
    ys, st = _sequential(*args)
    y, h = ssm.ssd_chunked(*map(_t, args), chunk=chunk)
    ry, rh = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    for got, want in ((y, ys), (h, st), (y, ry), (h, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("l,chunk", [(32, 8), (30, 8)])
def test_ssd_chunked_grads_match_jax(l, chunk):
    """Gradients of a loss on y and the final state with respect to every
    input, against `jax.grad` of the reference's scan; at l = 30 the
    chunk does not divide the length and the scan is one chunk (the
    reference's rule for every short prompt)."""
    rng = np.random.default_rng(1)
    args = _scan_inputs(rng, l=l)
    wy = rng.normal(size=args[0].shape).astype(np.float32)
    wh = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)

    def ref_loss(*xs):
        y, h = ref_ssm.ssd_chunked(*xs, chunk=chunk)
        return jnp.sum(jnp.tanh(y) * wy) + jnp.sum(h * wh)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    xs = [_t(x).requires_grad_() for x in args]
    y, h = ssm.ssd_chunked(*xs, chunk=chunk)
    (torch.sum(torch.tanh(y) * _t(wy)) + torch.sum(h * _t(wh))).backward()
    for x, g in zip(xs, want):
        assert torch.isfinite(x.grad).all()
        _close(x.grad, g, 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    k, c = 4, 12
    p = {"conv_w": rng.normal(size=(k, c)).astype(np.float32),
         "conv_b": rng.normal(size=(c,)).astype(np.float32)}
    u = rng.normal(size=(2, 1 if with_state else 9, c)).astype(np.float32)
    state = (rng.normal(size=(2, k - 1, c)).astype(np.float32)
             if with_state else None)
    ry, rs = ref_ssm._conv(jax.tree.map(jnp.asarray, p), jnp.asarray(u),
                           None if state is None else jnp.asarray(state))
    y, s = ssm._conv(tree_map(_t, p), _t(u),
                     None if state is None else _t(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert s._base is None  # its own storage, not a view of the input


def _layer_params(cfg, rng):
    """One ssm layer's parameters, weight matrices at std 1/sqrt(d_in),
    a_log and dt_bias drawn so that the decays and steps vary by head."""
    def draw(path, spec):
        if spec.init == "ones" and path != "d_skip":
            return np.ones(spec.shape, np.float32)
        if path in ("a_log", "dt_bias"):
            return rng.uniform(-1.0, 1.0, spec.shape).astype(np.float32)
        return (rng.normal(size=spec.shape) / np.sqrt(spec.shape[0])).astype(
            np.float32)
    specs = ssm.ssm_specs(cfg)
    return {k: (draw(k, v) if not isinstance(v, dict)
                else {kk: draw(kk, vv) for kk, vv in v.items()})
            for k, v in specs.items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_apply_ssm_matches_reference(arch, kind):
    """`apply_ssm` on the smoke layer against the reference's: a prefill of
    40 positions (chunks of 8, and so five of them), its cache; a decode
    step from a drawn cache, written in place; train also its input
    gradient."""
    cfg, jcfg = get_smoke_config(arch), ref_smoke(arch)
    rng = np.random.default_rng(3)
    p = _layer_params(cfg, rng)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    b, s = 2, 40
    x = rng.normal(size=(b, 1 if kind == "decode" else s,
                         cfg.d_model)).astype(np.float32)
    if kind == "decode":
        d_inner, nheads, n = ssm.ssm_dims(cfg)
        cache = {"h": rng.normal(size=(b, nheads, n, cfg.ssm_head_dim))
                 .astype(np.float32),
                 "conv": rng.normal(size=(b, cfg.ssm_conv - 1,
                                          d_inner + 2 * n)).astype(
                                              np.float32)}
        jo, jc = ref_ssm.apply_ssm(jp, jnp.asarray(x), jcfg, kind="decode",
                                   cache=jax.tree.map(jnp.asarray, cache))
        tc = tree_map(_t, cache)
        to, nc = ssm.apply_ssm(tp, _t(x), cfg, kind="decode", cache=tc)
        _close(to, jo, 1e-4)
        for key in ("h", "conv"):
            assert nc[key] is tc[key]  # written in place
            _close(nc[key], jc[key], 1e-4)
        assert nc["h"].dtype == torch.float32
        return
    if kind == "prefill":
        jo, jc = ref_ssm.apply_ssm(jp, jnp.asarray(x), jcfg, kind="prefill",
                                   chunk=8)
        to, tc = ssm.apply_ssm(tp, _t(x), cfg, kind="prefill", chunk=8)
        _close(to, jo, 1e-4)
        assert sorted(tc) == ["conv", "h"]
        for key in tc:
            _close(tc[key], jc[key], 1e-4)
        return

    def ref(x):
        o, c = ref_ssm.apply_ssm(jp, x, jcfg, kind="train", chunk=8)
        assert c is None
        return jnp.sum(jnp.tanh(o)), o

    (_, want), want_g = jax.value_and_grad(ref, has_aux=True)(x)
    tx = torch.tensor(x, requires_grad=True)
    out, cache = ssm.apply_ssm(tp, tx, cfg, kind="train", chunk=8)
    torch.tanh(out).sum().backward()
    assert cache is None
    _close(out, want, 1e-4)
    _close(tx.grad, want_g, 1e-4)


def test_remat_forwards_counts_attention_layers():
    """The remat's attention forwards a step count the layers that attend:
    zamba2's ssm_attn layers (27 groups = 9 x 3: 9 x 1 x 8 = 72), none of
    mamba2's, and gemma2's as before (21 groups = 7 x 3, two attention
    layers a group: 112); counted through the plain forward and backward
    on zamba2's smoke layers cut to 6 groups (3 x 2: 3 x (3 + 2) = 15)."""
    from repro_torch.models import flash_xla
    assert lm.remat_forwards(get_config("zamba2_7b")) == 72
    assert lm.attention_layers(get_config("zamba2_7b")) == 27
    assert lm.remat_forwards(get_config("mamba2_780m")) == 0
    assert lm.attention_layers(get_config("mamba2_780m")) == 0
    assert lm.remat_forwards(get_config("gemma2_9b")) == 7 * 2 * 8 == 112
    cfg = get_smoke_config("zamba2_7b").scaled(num_layers=18)
    assert lm._sqrt_split(cfg.pattern_groups) == (3, 2)
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
        grads = torch.autograd.grad(loss, tree_leaves(m.params))
    finally:
        flash_xla.flash_attention_fwd_plain = fwd
        flash_xla.flash_attention_bwd_plain = bwd
    assert lm.remat_forwards(cfg) == 15
    assert calls == {"fwd": 15, "bwd": 6}
    assert all(torch.isfinite(g).all() for g in grads)


def test_pad_cache_keeps_the_ssm_leaves():
    """`pad_cache` pads the shared block's k and v to the decode length
    and leaves the sequence-free SSM leaves as they are, cast to the
    template's dtype (``h`` stays f32)."""
    m = Model(get_smoke_config("zamba2_7b")).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 128,
                                                              (2, 10)))
    _, cache = m.prefill(toks)
    padded = m.pad_cache(cache, 2, 32, torch.bfloat16)
    ssm0, attn = padded["2"]["ssm"], padded["2"]["shared_attn"]
    assert ssm0["h"].dtype == torch.float32
    assert torch.equal(ssm0["h"], cache["2"]["ssm"]["h"])
    assert ssm0["conv"].dtype == torch.bfloat16
    assert torch.equal(ssm0["conv"],
                       cache["2"]["ssm"]["conv"].to(torch.bfloat16))
    assert attn["k"].shape[2] == 32
    assert torch.equal(attn["k"][:, :, :10].float(),
                       cache["2"]["shared_attn"]["k"].to(torch.bfloat16)
                       .float())
    assert not attn["k"][:, :, 10:].any()


def test_train_cli_smoke(tmp_path):
    """The counterpart of `tests/test_dryrun.py::test_train_cli_smoke`."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2_780m", "--smoke", "--steps", "6", "--batch", "2",
         "--seq", "64", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ckpt")],
        capture_output=True, text=True, cwd=ROOT, timeout=480,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "done: steps=6" in r.stdout


MESH_SCRIPT = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, "src")
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.cluster import init_cluster
    from repro_torch.models import Model, ssm
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train.trainer import pin

    rank, _ = init_cluster(device="cpu")
    mesh = meshlib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = meshlib.DEFAULT_RULES
    scans, scan = [], ssm.ssd_chunked
    ssm.ssd_chunked = lambda xh, *a, **k: (
        scans.append(list(xh.shape)) or scan(xh, *a, **k))
    out = {}
    for arch in ("mamba2_780m", "zamba2_7b"):
        cfg = get_smoke_config(arch)
        base = Model(cfg).init(0, torch.float64, "cpu").params
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (8, 32)))
                 for k in ("tokens", "labels")}
        one = Model(cfg).load(tree_map(lambda t: t.clone(), base),
                              trainable=True)
        loss1 = one.loss_fn(one.params, batch)
        g1 = torch.autograd.grad(loss1, tree_leaves(one.params))
        del scans[:]
        m = Model(cfg)
        m.load(meshlib.distribute_tree(tree_map(lambda t: t.clone(), base),
                                       m.param_axes(), mesh, rules),
               trainable=True)
        sharded = {k: meshlib.distribute(v, mesh, meshlib.sharding_for(
            ("act_batch", "act_seq"), (8, 32), mesh, rules))
            for k, v in batch.items()}
        with meshlib.sharding_context(mesh, rules):
            loss2 = m.loss_fn(m.params, sharded)
            leaves = tree_leaves(m.params)
            g2 = [pin(g, w).full_tensor() for g, w in zip(
                torch.autograd.grad(loss2, leaves), leaves)]
            loss2 = float(loss2.full_tensor())
        out[arch] = {
            "loss": [float(loss1), loss2],
            "grad_err_of_max": max(
                float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))
                for a, b in zip(g1, g2)),
            "scan_shapes": [list(s) for s in {tuple(s) for s in scans}],
            "heads": ssm.ssm_dims(cfg)[1]}
    if rank == 0:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both smoke models' loss and gradients in float64, on one device and
    over a 2x2 mesh of 4 gloo ranks (each rank a ``python -c`` process
    with torchrun's variables)."""
    path = tmp_path_factory.mktemp("ssm_mesh") / "out.json"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_SCRIPT, str(path)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_sharded_ssm_matches_one_device(mesh_runs, arch):
    """Over the mesh each rank scans only its own rows and heads (4 of 8
    rows, half the heads: whole heads of ssm_inner's model shards, B and
    C whole), and the loss and every gradient leaf, reduced to the
    weight's placements, equal one device's in float64 (1e-10 of each
    leaf's max |g|)."""
    run = mesh_runs[arch]
    assert run["scan_shapes"] == [[4, 32, run["heads"] // 2, 16]]
    loss1, loss2 = run["loss"]
    assert abs(loss1 - loss2) <= 1e-12 * abs(loss1)
    assert run["grad_err_of_max"] <= 1e-10
