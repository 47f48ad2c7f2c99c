"""The port's qwen1.5-110b (QKV bias), llava-next-34b (a vlm's stub patch
embeddings), minicpm3-4b (MLA), llama4-scout-17b-16e (MoE with GQA),
deepseek-v2-lite-16b (MoE with MLA), mamba2-780m (SSM), zamba2-7b (SSM
with a weight-tied shared attention block) and seamless-m4t-large-v2 (the
encoder-decoder over stub audio frames) against the JAX package, on their smoke
configurations in f32 on the CPU route, with parameters carried across
(`params_from_jax`) and numpy-seeded inputs.

The tolerances are those of the gemma2 cases (`tests/test_torch_models.py`:
logits 1e-4, cache leaves 1e-4 of their largest magnitude; decode equal to
the full forward within 2e-3, as `tests/test_models.py`) and of the train
parities (`tests/test_torch_train.py`: loss 1e-5 relative, each gradient
leaf within 1e-4 of its largest |g|, from weights at std 1/sqrt(d_in)).
`input_specs` and the caches' axes on the four shapes are held to the
reference's in `tests/test_torch_mesh.py`, which covers every ported
architecture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as ref_layers
from repro.models import config as ref_cfgmod
from repro.models.model import Model as RefModel

torch = pytest.importorskip("torch")
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model, blocks, layers, params_from_jax  # noqa: E402
from repro_torch.models import config as cfgmod  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from test_torch_train import _trained_scale  # noqa: E402

ARCHS = ["qwen1p5_110b", "llava_next_34b", "minicpm3_4b",
         "llama4_scout_17b_16e", "deepseek_v2_lite_16b", "mamba2_780m",
         "zamba2_7b", "seamless_m4t_large_v2"]
# parameters at full size, counted by the reference's Model.num_params()
FULL_PARAMS = {"qwen1p5_110b": 111_235_080_192,
               "llava_next_34b": 34_410_937_344,
               "minicpm3_4b": 4_263_336_448,
               "llama4_scout_17b_16e": 107_777_070_080,
               "deepseek_v2_lite_16b": 16_210_324_992,
               "mamba2_780m": 781_562_112,
               "zamba2_7b": 6_756_635_856,
               "seamless_m4t_large_v2": 2_038_556_672}

# the SSMs' cases start from weights at std 1/sqrt(d_in): at the init's
# scale (the stacked in_proj at 1/sqrt(G)) zamba2's smoke logits lie 7.2e-5
# (port) and 5.8e-5 (JAX) from a float64 evaluation, 1.2e-4 apart; at
# 1/sqrt(d_in), 2.3e-5 each
SSM_ARCHS = ("mamba2_780m", "zamba2_7b")
# and so does the encoder-decoder: at the init's scale (its 2 stacked
# layers at std 1/sqrt(2)) a smoke block's outputs reach the hundreds and
# the prefill logits of the two packages lie 3.9e-4 of their max apart,
# the port's 1.06e-4 from a float64 evaluation and the JAX package's
# 3.07e-4 (`tests/test_torch_encdec.py::test_init_scale_logits_vs_float64`)
TRAINED_SCALE_ARCHS = SSM_ARCHS + ("seamless_m4t_large_v2",)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (as `test_torch_models.py`)."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, its params as numpy, the port's model on them)."""
    arch = request.param
    jm = RefModel(ref_smoke(arch))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                          jnp.float32))
    if arch in TRAINED_SCALE_ARCHS:
        jp = _trained_scale(jp)
    tm = Model(configs.get_smoke_config(arch)).load(
        params_from_jax(jp, device="cpu"))
    return arch, jm, jp, tm


def _batch(cfg, rng, b, s):
    """A prefill batch of ``s`` positions: tokens, and for a vlm its
    ``num_patch_tokens`` patch embeddings ahead of s - P tokens; for an
    encoder-decoder also its ``source_len`` frames."""
    p = cfg.num_patch_tokens if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p))}
    if p:
        batch["patch_embeds"] = rng.normal(size=(b, p, cfg.d_model)).astype(
            np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            size=(b, cfg.source_len, cfg.d_model)).astype(np.float32)
    return batch


def _extra(batch):
    """The prefill's keyword inputs besides the tokens (a vlm's patches, an
    encoder-decoder's frames), as torch tensors."""
    return {k: _t(v) for k, v in batch.items()
            if k in ("patch_embeds", "frames")}


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its path ("groups/0/moe/...")."""
    return {k: _paths(v, f"{prefix}{k}/") if isinstance(v, dict)
            else prefix + k for k, v in tree.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels")
                           else jnp.float32) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for get, jget in ((configs.get_config, ref_config),
                      (configs.get_smoke_config, ref_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
            jget(arch))
    dashed = arch.replace("_", "-").replace("p", ".")
    assert configs.get_config(dashed) == configs.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_equals_reference_without_allocation(arch):
    n = Model(configs.get_config(arch)).num_params()
    assert n == RefModel(ref_config(arch)).num_params() == FULL_PARAMS[arch]
    shapes = Model(configs.get_config(arch)).param_shapes()
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))


def test_prefill_matches_jax(pair):
    """Prefill logits and cache; the encoder-decoder's 40 positions over
    its 24 frames are the non-causal Sq > Skv cross-attention."""
    arch, jm, jp, tm = pair
    rng = np.random.default_rng(2)
    batch = _batch(tm.cfg, rng, 2, 40)
    jl, jc = jm.prefill(jax.tree.map(jnp.asarray, jp), _jax_batch(batch))
    tl, tc = tm.prefill(_t(batch["tokens"]).long(), **_extra(batch))
    assert tl.shape == (2, 40, jm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape)
                                                 for t in tleaves]
    for got, want in zip(tleaves, jleaves):
        _close(got, want, 1e-4)


def test_decode_matches_full_forward(pair):
    """As `tests/test_models.py::test_decode_matches_full_forward`: the
    cache of a prefill of the first half, then one decode step a token,
    against the full prefill's logits (a vlm's patches, an
    encoder-decoder's frames in both)."""
    _, _, _, tm = pair
    rng = np.random.default_rng(1)
    b, s = 2, 24
    batch = _batch(tm.cfg, rng, b, s)
    toks = _t(batch["tokens"])
    extra = _extra(batch)
    p = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    full, _ = tm.prefill(toks, **extra)
    s0 = (s - p) // 2
    _, cache = tm.prefill(toks[:, :s0], **extra)
    cache = tm.pad_cache(cache, b, s, torch.float32)
    errs = []
    for t in range(s0, s - p):
        ln, cache = tm.decode_step(cache, toks[:, t], p + t)
        errs.append(float((ln - full[:, p + t]).abs().max()))
    assert len(errs) >= 6 and max(errs) < 2e-3, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """One train step's loss and gradients against `jax.value_and_grad` of
    the reference's `loss_fn`, through the CPU route of the attention
    (MLA: the (24, 16) head_dim pair) and, for llava, the patches; zamba2's
    shared leaves get the sum over every ssm_attn layer; seamless's
    encoder leaves get the cross-attention's dk and dv through the
    memory (its 32 decoder positions over 24 frames: non-causal Sq >
    Skv in the backward too)."""
    rng = np.random.default_rng(0)
    cfg = configs.get_smoke_config(arch)
    jm = RefModel(ref_smoke(arch))
    jp = _trained_scale(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.float32)))
    batch = _batch(cfg, rng, 2, 32)
    batch["labels"] = rng.integers(-1, cfg.vocab_size, (2, 32))
    want_loss, want = jax.value_and_grad(jm.loss_fn)(
        jax.tree.map(jnp.asarray, jp), _jax_batch(batch))
    m = Model(cfg).load(params_from_jax(jp, device="cpu"), trainable=True)
    loss = m.loss_fn(m.params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(m.params))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    leaves = jax.tree.leaves(want)
    assert len(grads) == len(leaves)
    paths = []
    tree_map(lambda _, path: paths.append(path), m.params, _paths(m.params))
    largest = max(float(np.abs(np.asarray(w)).max()) for w in leaves)
    for path, g, w in zip(paths, grads, leaves):
        w = np.asarray(w, np.float64)
        g = g.numpy().astype(np.float64)
        if cfg.moe_top_k == 1 and path.endswith("/router"):
            # top-1 routing: the gate is p / p = 1, so the router's exact
            # gradient is 0, and both packages give rounding noise there
            assert np.abs(w).max() <= 1e-6 * largest
            assert np.abs(g).max() <= 1e-6 * largest
            continue
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), path


@pytest.mark.parametrize("shape_name", list(ref_cfgmod.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape_name):
    """Every input's shape and logical axes, and the dtype of the patch
    embeddings, on the four shapes at full size."""
    shape = ref_cfgmod.SHAPES[shape_name]
    r_in, r_ax = RefModel(ref_config(arch)).input_specs(shape, jnp.bfloat16)
    p_in, p_ax = Model(configs.get_config(arch)).input_specs(
        cfgmod.SHAPES[shape_name])
    assert list(p_in) == list(r_in)
    for name in r_in:
        assert jax.tree.map(lambda a: tuple(a.shape), r_in[name]) == \
            tree_map(lambda t: tuple(t.shape), p_in[name]), name
        assert jax.tree.map(tuple, r_ax[name], is_leaf=lambda x:
                            isinstance(x, tuple)) == p_ax[name], name
    if "patch_embeds" in p_in:
        assert p_in["patch_embeds"].dtype == torch.bfloat16
        assert p_in["patch_embeds"].shape[1] == 2880
    if "frames" in p_in:
        assert p_in["frames"].dtype == torch.bfloat16
        assert p_in["frames"].shape[1] == 4096


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_apply_mla_matches_jax(kind):
    """`apply_mla` against the reference's on minicpm3's smoke layer: the
    expanded form (train and prefill, through `attend_flash` and the
    kernel wrapper's plain route at (24, 16)) and the absorbed decode
    over a compressed cache, written in place; train also its input
    gradient."""
    cfg = configs.get_smoke_config("minicpm3_4b")
    jcfg = ref_smoke("minicpm3_4b")
    rng = np.random.default_rng(3)
    specs = layers.mla_specs(cfg)
    p = tree_map(lambda s: (np.ones(s.shape, np.float32) if s.init == "ones"
                            else rng.normal(size=s.shape).astype(np.float32)
                            / np.sqrt(s.shape[0])), specs)
    jp, tp = jax.tree.map(jnp.asarray, p), tree_map(_t, p)
    b, s = 2, 30
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    if kind == "decode":
        lora, r = cfg.kv_lora_rank, cfg.rope_head_dim
        cache = {"c_kv": rng.normal(size=(b, s + 2, lora)).astype(
                     np.float32),
                 "k_rope": rng.normal(size=(b, s + 2, r)).astype(np.float32)}
        xd = x[:, :1]
        jo, jc = ref_layers.apply_mla(
            jp, jnp.asarray(xd), jcfg, kind="decode",
            positions=jnp.full((b, 1), s), cache=jax.tree.map(jnp.asarray,
                                                              cache),
            index=jnp.int32(s))
        tcache = {k: _t(v) for k, v in cache.items()}
        to, tc = layers.apply_mla(tp, _t(xd), cfg, kind="decode",
                                  positions=torch.full((b, 1), s),
                                  cache=tcache, index=s)
        _close(to, jo, 1e-5)
        assert tc["c_kv"] is tcache["c_kv"]  # written in place
        for key in ("c_kv", "k_rope"):
            _close(tc[key], jc[key], 1e-5)
        return
    if kind == "prefill":
        jo, jc = ref_layers.apply_mla(jp, jnp.asarray(x), jcfg,
                                      kind="prefill",
                                      positions=jnp.asarray(pos))
        to, tc = layers.apply_mla(tp, _t(x), cfg, kind="prefill",
                                  positions=_t(pos))
        _close(to, jo, 1e-5)
        assert sorted(tc) == ["c_kv", "k_rope"]
        for key in tc:
            _close(tc[key], jc[key], 1e-5)
        return

    def ref(x):
        o, c = ref_layers.apply_mla(jp, x, jcfg, kind="train",
                                    positions=jnp.asarray(pos))
        assert c is None
        return jnp.sum(jnp.tanh(o)), o

    (_, want), want_g = jax.value_and_grad(ref, has_aux=True)(x)
    tx = torch.tensor(x, requires_grad=True)
    out, cache = layers.apply_mla(tp, tx, cfg, kind="train",
                                  positions=_t(pos))
    torch.tanh(out).sum().backward()
    assert cache is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               rtol=2e-4, atol=2e-4)


def test_mla_cache_and_blocks():
    """MLA's block: its specs and compressed cache, as the reference's
    (c_kv [B, S, kv_lora], k_rope [B, S, r]), their axes; a bidir block on
    an MLA config takes MLA's specs, as the reference's does; an unknown
    kind raises."""
    from repro.models import blocks as ref_blocks
    cfg = configs.get_smoke_config("minicpm3_4b")
    shapes = tree_map(lambda s: s.shape, blocks.block_specs(cfg, "dense"))
    want = jax.tree.map(lambda s: s.shape, ref_blocks.block_specs(
        ref_smoke("minicpm3_4b"), "dense"),
        is_leaf=lambda x: hasattr(x, "init"))
    assert shapes == want
    cache = blocks.cache_struct(cfg, "dense", 2, 8, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache["attn"].items()} == {
        "c_kv": (2, 8, 32), "k_rope": (2, 8, 8)}
    bidir = tree_map(lambda s: s.shape, blocks.block_specs(cfg, "bidir"))
    assert bidir == want
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.block_specs(cfg, "cross")


def test_serve_extra_reaches_every_wave():
    """`ServeEngine.serve(..., extra=)` hands the patch embeddings to each
    wave's prefill unchanged (the reference's contract: their batch dim is
    the wave's), and the tokens follow from them."""
    from repro_torch.serve import ServeEngine
    cfg = configs.get_smoke_config("llava_next_34b")
    model = Model(cfg).init(0, device="cpu")
    seen = []
    prefill = model.prefill

    def spy(tokens, **kw):
        seen.append(kw["patch_embeds"])
        return prefill(tokens, **kw)
    model.prefill = spy
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, 6).tolist() for _ in range(4)]
    eng = ServeEngine(model, max_batch=2, max_seq=64)
    patches = torch.from_numpy(rng.normal(size=(2, cfg.num_patch_tokens,
                                                cfg.d_model)).astype(
                                                    np.float32))
    out = eng.serve(reqs, max_new=4, extra={"patch_embeds": patches})
    assert len(seen) == eng.stats.waves == 2
    assert all(t is patches for t in seen)
    other = torch.from_numpy(rng.normal(size=patches.shape).astype(
        np.float32))
    assert eng.serve(reqs, max_new=4, extra={"patch_embeds": other}) != out


@pytest.mark.parametrize("arch,shape_name", [("minicpm3_4b", "decode_32k"),
                                             ("llava_next_34b",
                                              "prefill_32k"),
                                             ("mamba2_780m", "long_500k"),
                                             ("zamba2_7b", "long_500k")])
def test_dryrun_cells_of_the_new_architectures(tmp_path, arch, shape_name):
    """The dry-run CLI takes the new architectures: minicpm3-4b's decode
    cell traces its compressed cache (c_kv, k_rope: the arguments hold at
    least a rank's share of it), llava-next-34b's prefill cell its patch
    embeddings; 56 and 40 heads over the 16-way model axis included; the
    SSMs' long_500k decode (traced only for sub-quadratic architectures)
    its h and conv leaves, and zamba2's shared block's 524,288-position
    k and v."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape_name, "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=root, timeout=570, env=env)
    assert "DRY-RUN PASS" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.load(open(tmp_path / f"{arch}_{shape_name}_single.json"))
    assert out["num_params"] == FULL_PARAMS[arch] and out["chips"] == 256
    assert out["memory"]["peak_estimate_bytes"] > 0
    if shape_name.startswith("decode"):
        shape = cfgmod.SHAPES[shape_name]
        cache = Model(configs.get_config(arch)).cache_shapes(
            shape.global_batch, shape.seq_len)
        want = {"minicpm3_4b": {"attn": ["c_kv", "k_rope"]},
                "mamba2_780m": {"ssm": ["conv", "h"]},
                "zamba2_7b": {"ssm": ["conv", "h"]}}[arch]
        for key, leaves in want.items():
            assert sorted(cache["0"][key]) == leaves
        if arch == "zamba2_7b":
            assert cache["2"]["shared_attn"]["k"].shape[2] == 524288
        total = sum(t.numel() * t.element_size()
                    for t in tree_leaves(cache))
        assert out["memory"]["argument_bytes"] >= total // 256
