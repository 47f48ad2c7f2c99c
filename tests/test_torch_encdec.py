"""The port's encoder-decoder (seamless-m4t-large-v2: `models.encdec`, the
bidir and xdec blocks, cross-attention) against the JAX package, beyond
what `tests/test_torch_zoo.py` covers: the layers in their three kinds,
the cache trees, serving with stub frames against the JAX `ServeEngine`,
and the serving and dry-run launchers.

Smoke configuration in f32 on the CPU route (the kernels' plain
versions), parameters carried across with `params_from_jax`, inputs from
a numpy seed.  Tolerances are the zoo's: layer outputs 1e-5 of their
largest magnitude (`test_apply_mla_matches_jax`'s), train outputs and
input gradients rtol = atol = 2e-4 (the gradient test's bar); tokens
equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.models import blocks as ref_blocks
from repro.models import encdec as ref_encdec
from repro.models import layers as ref_layers
from repro.models.model import Model as RefModel
from repro.serve import ServeEngine as RefServeEngine

torch = pytest.importorskip("torch")
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import Model, blocks, encdec, layers  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_train import _trained_scale  # noqa: E402

ARCH = "seamless_m4t_large_v2"
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


def _layer_params(specs, rng):
    """Random parameters of a spec tree at std 1/sqrt(d_in) (norms at
    one), as numpy."""
    return tree_map(lambda s: (np.ones(s.shape, np.float32)
                               if s.init == "ones" else
                               rng.normal(size=s.shape).astype(np.float32)
                               / np.sqrt(s.shape[0])), specs)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_apply_cross_attn_matches_jax(kind):
    """Cross-attention of 30 decoder positions over 24 frames (non-causal
    Sq > Skv) against the reference's: prefill computes and returns the
    memory's k and v; decode reads them from the cache (one query over
    the frames) and returns no new cache; train also the gradients of x
    and of the memory, through `attend_flash`."""
    cfg, jcfg = configs.get_smoke_config(ARCH), ref_smoke(ARCH)
    rng = np.random.default_rng(7)
    p = _layer_params(layers.cross_attn_specs(cfg), rng)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    b, s, sm, h, hd = 2, 30, cfg.source_len, cfg.num_heads, cfg.head_dim
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(b, sm, cfg.d_model)).astype(np.float32)
    if kind == "decode":
        cache = {n: rng.normal(size=(b, sm, h, hd)).astype(np.float32)
                 for n in ("xk", "xv")}
        jo, jc = ref_layers.apply_cross_attn(
            jp, jnp.asarray(x[:, :1]), None, jcfg, kind="decode",
            cache=jax.tree.map(jnp.asarray, cache))
        to, tc = layers.apply_cross_attn(tp, _t(x[:, :1]), None, cfg,
                                         kind="decode",
                                         cache=tree_map(_t, cache))
        assert jc is None and tc is None
        _close(to, jo, 1e-5)
        return
    if kind == "prefill":
        jo, jc = ref_layers.apply_cross_attn(jp, jnp.asarray(x),
                                             jnp.asarray(mem), jcfg,
                                             kind="prefill")
        to, tc = layers.apply_cross_attn(tp, _t(x), _t(mem), cfg,
                                         kind="prefill")
        _close(to, jo, 1e-5)
        assert sorted(tc) == ["xk", "xv"]
        for key in tc:
            assert tuple(tc[key].shape) == (b, sm, h, hd)
            _close(tc[key], jc[key], 1e-5)
        return

    def ref(x, mem):
        o, c = ref_layers.apply_cross_attn(jp, x, mem, jcfg, kind="train")
        assert c is None
        return jnp.sum(jnp.tanh(o)), o

    (_, want), want_g = jax.value_and_grad(ref, argnums=(0, 1),
                                           has_aux=True)(x, mem)
    tx, tm = (torch.tensor(a, requires_grad=True) for a in (x, mem))
    out, cache = layers.apply_cross_attn(tp, tx, tm, cfg, kind="train")
    torch.tanh(out).sum().backward()
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    for t, w in zip((tx, tm), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("block_kind,kind", [
    ("bidir", "train"), ("bidir", "prefill"), ("xdec", "train"),
    ("xdec", "prefill"), ("xdec", "decode")])
def test_block_matches_jax(block_kind, kind):
    """A bidir block (the encoder's: non-causal self-attention; the
    encoder runs once a prefill, so it has no decode) and an xdec block
    (causal self-attention, cross-attention over the memory, MLP) against
    the reference's `apply_block`.  Train also compares the input
    gradient (and the memory's, for xdec); prefill the caches; decode
    writes the self-attention cache in place and hands the cross cache
    through unchanged."""
    cfg, jcfg = configs.get_smoke_config(ARCH), ref_smoke(ARCH)
    rng = np.random.default_rng(11)
    p = _layer_params(blocks.block_specs(cfg, block_kind), rng)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    b, s, sm = 2, 30, cfg.source_len
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    mem = (rng.normal(size=(b, sm, cfg.d_model)).astype(np.float32)
           if block_kind == "xdec" else None)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    jmem = None if mem is None else jnp.asarray(mem)
    tmem = None if mem is None else _t(mem)
    if kind == "decode":
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cache = {"attn": {n: rng.normal(size=(b, s + 2, hkv, hd)).astype(
                     np.float32) for n in ("k", "v")},
                 "xattn": {n: rng.normal(size=(b, sm, h, hd)).astype(
                     np.float32) for n in ("xk", "xv")}}
        jo, jc = ref_blocks.apply_block(
            jp, jnp.asarray(x[:, :1]), jcfg, "xdec", kind="decode",
            positions=jnp.full((b, 1), s),
            cache=jax.tree.map(jnp.asarray, cache), index=jnp.int32(s))
        tcache = tree_map(_t, cache)
        to, tc = blocks.apply_block(tp, _t(x[:, :1]), cfg, "xdec",
                                    kind="decode",
                                    positions=torch.full((b, 1), s),
                                    cache=tcache, index=s)
        _close(to, jo, 1e-5)
        assert tc["attn"]["k"] is tcache["attn"]["k"]  # written in place
        assert tc["xattn"] is tcache["xattn"]  # static after prefill
        for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            _close(got, want, 1e-5)
        return
    if kind == "prefill":
        jo, jc = ref_blocks.apply_block(jp, jnp.asarray(x), jcfg,
                                        block_kind, kind="prefill",
                                        positions=jnp.asarray(pos),
                                        memory=jmem)
        to, tc = blocks.apply_block(tp, _t(x), cfg, block_kind,
                                    kind="prefill", positions=_t(pos),
                                    memory=tmem)
        _close(to, jo, 1e-5)
        assert jax.tree.map(lambda a: a.shape, jc) == tree_map(
            lambda t: tuple(t.shape), tc)
        for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            _close(got, want, 1e-5)
        return

    def ref(x, mem):
        o, _ = ref_blocks.apply_block(jp, x, jcfg, block_kind, kind="train",
                                      positions=jnp.asarray(pos), memory=mem)
        return jnp.sum(jnp.tanh(o)), o

    args = (x,) if mem is None else (x, mem)
    (_, want), want_g = jax.value_and_grad(
        lambda *a: ref(a[0], a[1] if len(a) > 1 else None),
        argnums=tuple(range(len(args))), has_aux=True)(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out, _ = blocks.apply_block(tp, ts[0], cfg, block_kind, kind="train",
                                positions=_t(pos),
                                memory=ts[1] if len(ts) > 1 else None)
    torch.tanh(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("full", [False, True])
def test_cache_trees_match_reference(full):
    """`encdec_init_cache` (zeros, on the CPU when asked) and
    `encdec_cache_axes` against the reference's: same keys, shapes
    ([L, B, S, Hkv, hd] self-attention, [L, B, source_len, H, hd] cross)
    and axes; at full size as meta tensors (`Model.cache_shapes`)."""
    get = configs.get_config if full else configs.get_smoke_config
    from repro.configs import get_config as ref_config
    cfg = get(ARCH)
    jcfg = ref_config(ARCH) if full else ref_smoke(ARCH)
    want = jax.eval_shape(lambda: ref_encdec.encdec_init_cache(
        jcfg, 2, 40, jnp.float32))
    if full:
        got = Model(cfg).cache_shapes(2, 40, torch.float32)
        assert all(t.device.type == "meta" for t in tree_leaves(got))
    else:
        got = encdec.encdec_init_cache(cfg, 2, 40, torch.float32, "cpu")
        assert all(not t.any() for t in tree_leaves(got))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == tree_map(
        lambda t: tuple(t.shape), got)
    assert got["0"]["xattn"]["xk"].shape[2] == cfg.source_len
    axes = jax.tree.map(tuple, ref_encdec.encdec_cache_axes(jcfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    assert encdec.encdec_cache_axes(cfg) == axes
    assert Model(cfg).cache_axes() == axes


def _count_attention(monkeypatch) -> dict:
    """Counts of the attention calls from here on: the op's CPU kernel
    (prefill, decode) and `attend_flash`'s CPU route ("fwd"), its
    backward ("bwd")."""
    from repro_torch.models import flash_xla
    calls = {"fwd": 0, "bwd": 0}

    def count(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)
    count(tfa, "flash_attention_plain", "fwd")
    count(flash_xla, "flash_attention_fwd_plain", "fwd")
    count(flash_xla, "flash_attention_bwd_plain", "bwd")
    return calls


def _train_step_calls(cfg, calls) -> dict:
    """The attention calls of one loss-and-gradient step of ``cfg`` at 32
    decoder positions."""
    m = Model(cfg).init(0, device="cpu", trainable=True)
    rng = np.random.default_rng(0)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 32)))
    fr = _t(rng.normal(size=(2, cfg.source_len, cfg.d_model)).astype(
        np.float32))
    calls.update(fwd=0, bwd=0)
    loss = m.loss_fn(m.params, {"tokens": toks, "labels": toks,
                                "frames": fr})
    torch.autograd.grad(loss, tree_leaves(m.params))
    return dict(calls)


def test_launch_counts(monkeypatch):
    """The attention calls of a prefill (encoder + decoder self + cross),
    of a decode step (cross only) and of a train step (at 2 layers a
    stack each forward twice, the backward once), counted on the CPU
    route's plain versions (the card's kernels take the same calls)."""
    cfg = configs.get_smoke_config(ARCH)
    assert encdec.prefill_launches(cfg) == 2 + 2 * 2
    assert encdec.decode_launches(cfg) == 2
    assert encdec.remat_forwards(cfg) == 12
    full = configs.get_config(ARCH)
    assert (encdec.prefill_launches(full), encdec.decode_launches(full)) \
        == (72, 24)
    calls = _count_attention(monkeypatch)
    m = Model(cfg).init(0, device="cpu")
    rng = np.random.default_rng(0)
    toks = _t(rng.integers(0, cfg.vocab_size, (2, 32)))
    fr = _t(rng.normal(size=(2, cfg.source_len, cfg.d_model)).astype(
        np.float32))
    with torch.no_grad():
        _, cache = m.prefill(toks, frames=fr)
        assert calls["fwd"] == encdec.prefill_launches(cfg)
        cache = m.pad_cache(cache, 2, 34, torch.float32)
        m.decode_step(cache, toks[:, -1], 32)
    assert calls["fwd"] == encdec.prefill_launches(cfg) \
        + encdec.decode_launches(cfg)
    assert _train_step_calls(cfg, calls) == {
        "fwd": encdec.remat_forwards(cfg),
        "bwd": encdec.prefill_launches(cfg)}


def test_launch_counts_two_level_remat(monkeypatch):
    """At 4 + 4 layers (the card's parity model's depth) each stack runs
    `lm._run_train`'s two-level remat, (go, gi) = (2, 2): a layer's
    forward three times but in the last group of each segment, twice; the
    encoder's 4 layers 2 x (3 + 2) = 10 forwards, the decoder's two a
    layer 20."""
    cfg = configs.get_smoke_config(ARCH).scaled(num_layers=4,
                                                encoder_layers=4)
    assert encdec.remat_forwards(cfg) == 10 + 20
    calls = _count_attention(monkeypatch)
    assert _train_step_calls(cfg, calls) == {
        "fwd": encdec.remat_forwards(cfg),
        "bwd": encdec.prefill_launches(cfg)}


def test_init_scale_logits_vs_float64():
    """At the reference init's own scale (each stacked weight at std
    1/sqrt(2), so a smoke block's outputs reach the hundreds) the two
    packages' f32 prefill logits lie about 3.9e-4 of their max apart, over
    the zoo's 1e-4 bar, which is why the zoo's seamless cases take weights
    at 1/sqrt(d_in).  The gap is f32 rounding that the depth and scale
    amplify, not a fault of the port: against a float64 evaluation of the
    same parameters and inputs (the port's CPU route in float64; the JAX
    package's attention keeps f32 carries and cannot run in float64) the
    port's f32 logits lie no further than the JAX package's (measured on
    the CPU: port 1.06e-4, JAX 3.07e-4 of max |logit|), and at
    1/sqrt(d_in) all three agree within 2e-6."""
    from test_torch_zoo import _batch, _extra, _jax_batch
    jm = RefModel(ref_smoke(ARCH))
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            jnp.float32))
    cfg = configs.get_smoke_config(ARCH)
    batch = _batch(cfg, np.random.default_rng(2), 2, 40)
    errs = {}
    for name, jp in (("init", init), ("trained", _trained_scale(init))):
        jl, _ = jm.prefill(jax.tree.map(jnp.asarray, jp), _jax_batch(batch))
        tl, _ = Model(cfg).load(params_from_jax(jp, device="cpu")).prefill(
            _t(batch["tokens"]).long(), **_extra(batch))
        p64 = tree_map(lambda a: a.double(),
                       params_from_jax(jp, device="cpu"))
        l64, _ = Model(cfg).load(p64).prefill(
            _t(batch["tokens"]).long(),
            **{k: v.double() for k, v in _extra(batch).items()})
        l64 = l64.numpy()
        scale = np.abs(l64).max()
        errs[name] = {"port": np.abs(tl.numpy() - l64).max() / scale,
                      "jax": np.abs(np.asarray(jl, np.float64) - l64).max()
                      / scale}
    assert errs["init"]["port"] <= errs["init"]["jax"], errs
    assert max(errs["init"].values()) > 1e-4, errs  # the gap is real
    assert max(errs["trained"].values()) < 2e-6, errs


def test_serve_with_frames_matches_jax():
    """`ServeEngine.serve(..., extra={"frames": ...})` against the JAX
    `ServeEngine` on the same parameters (at 1/sqrt(d_in)) and frames:
    two length buckets of two rows (each wave's batch is the frames'),
    tokens and stats equal; other frames give other tokens."""
    import dataclasses
    jm = RefModel(ref_smoke(ARCH))
    jp = _trained_scale(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.float32)))
    tm = Model(configs.get_smoke_config(ARCH)).load(
        params_from_jax(jp, device="cpu"))
    rng = np.random.default_rng(4)
    reqs = [rng.integers(1, jm.cfg.vocab_size, n).tolist()
            for n in (7, 12, 7, 12)]
    fr = rng.normal(size=(2, jm.cfg.source_len, jm.cfg.d_model)).astype(
        np.float32)
    kw = dict(max_batch=2, max_seq=48)
    jeng = RefServeEngine(jm, jax.tree.map(jnp.asarray, jp), **kw)
    teng = ServeEngine(tm, **kw)
    want = jeng.serve(reqs, max_new=10, extra={"frames": jnp.asarray(fr)})
    got = teng.serve(reqs, max_new=10, extra={"frames": _t(fr)})
    assert got == want
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    other = _t(rng.normal(size=fr.shape).astype(np.float32))
    assert teng.serve(reqs, max_new=10, extra={"frames": other}) != got


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=timeout, env=env)


def test_serve_launcher_on_cpu():
    """The launcher serves the smoke encoder-decoder, each wave over its
    stub frames (`launch.serve.wave_inputs`), and prints the reference
    launcher's line."""
    import re
    r = _run(["repro_torch.launch.serve", "--arch", ARCH, "--smoke",
              "--device", "cpu", "--requests", "6", "--max-new", "8"], 300)
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.fullmatch(r"6 requests in [\d.]+s, [\d.]+ tok/s, waves=(\d+)\n",
                     r.stdout)
    assert m and int(m.group(1)) >= 1, r.stdout
    from repro_torch.launch import serve as launcher
    cfg = configs.get_smoke_config(ARCH)
    extra = launcher.wave_inputs(cfg, 3, torch.float32, "cpu")
    assert list(extra) == ["frames"]
    assert tuple(extra["frames"].shape) == (3, cfg.source_len, cfg.d_model)
    assert launcher.wave_inputs(configs.get_smoke_config("gemma2_9b"), 3,
                                torch.float32, "cpu") is None


def test_dryrun_decode_cell(tmp_path):
    """The counterpart of `tests/test_dryrun.py::test_dryrun_single_cell`
    on seamless x decode_32k: 256 chips, peak bytes > 0, a dominant
    term; the cross cache's xk/xv (4,096 frames, 16 heads) among the
    arguments, the 16 heads over the 16-way model axis."""
    r = _run(["repro_torch.launch.dryrun", "--arch", ARCH, "--shape",
              "decode_32k", "--mesh", "single", "--out", str(tmp_path)], 570)
    assert "DRY-RUN PASS" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.load(open(tmp_path / f"{ARCH}_decode_32k_single.json"))
    assert out["chips"] == 256 and out["num_params"] == 2_038_556_672
    assert out["memory"]["peak_estimate_bytes"] > 0
    assert out["roofline"]["dominant"] in ("compute", "memory", "collective")
    cache = Model(configs.get_config(ARCH)).cache_shapes(128, 32768)
    assert tuple(cache["0"]["xattn"]["xk"].shape) == (24, 128, 4096, 16, 64)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    assert out["memory"]["argument_bytes"] >= total // 256
