"""The port's LM layers and model (gemma2 smoke configuration, plain
PyTorch route on the CPU) against the JAX package, on parameters converted
with `params_from_jax` and numpy-seeded inputs, in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model, blocks, layers, params_from_jax  # noqa: E402
from repro_torch.models.params import (ParamSpec, init_params,  # noqa: E402
                                       tree_leaves, tree_map)

ARCH = "gemma2_9b"


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with the same params)."""
    jm = JModel(jget_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = Model(configs.get_smoke_config(ARCH)).load(
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    """max |got - want| <= tol * max |want|: a norm-wise bound, since the
    two frameworks sum in different orders and the random weights (scale
    1/sqrt(G) with G = 2 groups) make some outputs small differences of
    large terms."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_configs_are_the_references():
    for get, jget in ((configs.get_config, jget_config),
                      (configs.get_smoke_config, jget_smoke)):
        assert (dataclasses.asdict(get(ARCH))
                == dataclasses.asdict(jget(ARCH)))
    assert configs.get_config("gemma2-9b") == configs.get_config(ARCH)


@pytest.mark.parametrize("arch,ported", [("seamless_m4t_large_v2", True),
                                         ("no_such_arch", False)])
def test_unported_arch_raises(arch, ported):
    """Every architecture of the JAX package is ported (the last,
    seamless-m4t-large-v2, resolves to the reference's configurations);
    an unknown one still raises."""
    for get, jget in ((configs.get_config, jget_config),
                      (configs.get_smoke_config, jget_smoke)):
        if ported:
            assert (dataclasses.asdict(get(arch))
                    == dataclasses.asdict(jget(arch)))
        else:
            with pytest.raises(KeyError, match="unknown"):
                get(arch)
    from repro.configs import ARCH_IDS as jarch_ids
    assert sorted(configs.ARCH_IDS) == sorted(jarch_ids)


def test_unported_block_kind_raises():
    """Every block kind of the JAX package is ported: the
    encoder-decoder's xdec and bidir specs equal the reference's on
    gemma2's smoke config (xdec adds ``ln_x`` and the cross-attention's
    full-MHA ``xattn``), MLA attention (minicpm3-4b,
    `tests/test_torch_zoo.py`), the MoE block (`tests/test_torch_moe.py`)
    and the SSM blocks (`tests/test_torch_ssm.py`); an unknown kind still
    raises."""
    from repro.models import blocks as jblocks
    cfg, jcfg = configs.get_smoke_config(ARCH), jget_smoke(ARCH)
    for kind in ("xdec", "bidir"):
        want = jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                            jblocks.block_specs(jcfg, kind),
                            is_leaf=lambda x: hasattr(x, "init"))
        assert tree_map(lambda s: (s.shape, s.axes, s.init, s.scale),
                        blocks.block_specs(cfg, kind)) == want
    assert sorted(blocks.block_specs(cfg, "xdec")) == [
        "attn", "ln_attn", "ln_mlp", "ln_x", "mlp", "xattn"]
    with pytest.raises(ValueError, match="unknown block kind"):
        blocks.block_specs(cfg, "cross")
    mla = blocks.block_specs(configs.get_smoke_config("minicpm3_4b"),
                             "dense")
    assert "wkv_b" in mla["attn"] and "wq" not in mla["attn"]


def test_num_params_equals_reference_without_allocation():
    n = Model(configs.get_config(ARCH)).num_params()
    assert n == JModel(jget_config(ARCH)).num_params() == 9_241_404_928


def test_init_params_distributions():
    specs = {"n": ParamSpec((4, 500)), "o": ParamSpec((7,), init="ones"),
             "z": ParamSpec((3, 2), init="zeros"),
             "s": ParamSpec((2000,), scale=0.02)}
    p = init_params(specs, torch.Generator().manual_seed(1))
    again = init_params(specs, torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                   tree_leaves(again)))
    assert torch.equal(p["o"], torch.ones(7))
    assert torch.equal(p["z"], torch.zeros(3, 2))
    # normal x 1/sqrt(fan_in), fan_in the first dim, as the reference
    assert abs(float(p["n"].std()) - 0.5) < 0.02
    assert abs(float(p["s"].std()) - 0.02) < 0.002
    bf = init_params(specs, torch.Generator().manual_seed(1), torch.bfloat16)
    assert bf["n"].dtype == torch.bfloat16


def test_model_init_and_load(pair):
    _, _, tm = pair
    assert sum(p.numel() for p in tm.parameters()) == tm.num_params()
    assert not any(p.requires_grad for p in tm.parameters())
    fresh = Model(tm.cfg).init(0, device="cpu")
    assert fresh.params["embed"].shape == tm.params["embed"].shape
    bad = dict(tm.params, final_norm=torch.ones(3))
    with pytest.raises(ValueError, match="does not fit"):
        Model(tm.cfg).load(bad)


def test_rms_norm_rope_mlp_match_jax(pair):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32) * 30
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    xr = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).copy()
    _close(layers.rope(_t(xr), _t(pos), 10000.0),
           jlayers.rope(jnp.asarray(xr), jnp.asarray(pos), 10000.0), 1e-6)
    _, jp, tm = pair
    xm = rng.normal(size=(2, 9, 64)).astype(np.float32)
    _close(layers.apply_mlp(tree_map(lambda a: a[0],
                                     tm.params["groups"]["0"]["mlp"]),
                            _t(xm)),
           jlayers.apply_mlp(jax.tree.map(lambda a: a[0],
                                          jp["groups"]["0"]["mlp"]),
                             jnp.asarray(xm)), 1e-5)


@pytest.mark.parametrize("layer_kind", ["local", "global"])
def test_apply_gqa_matches_jax(pair, layer_kind):
    """Prefill (through the flash attention wrapper) and one decode step
    over a cache, for a window-16 local layer and a global one, 30 tokens
    so the window applies."""
    jm, jp, tm = pair
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    b, s = 2, 30
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    jpa = jax.tree.map(lambda a: a[0], jp["groups"]["0"]["attn"])
    tpa = tree_map(lambda a: a[0], tm.params["groups"]["0"]["attn"])
    kw = dict(layer_kind=layer_kind)
    jo, jc = jlayers.apply_gqa(jpa, jnp.asarray(x), jm.cfg, kind="prefill",
                               positions=jnp.asarray(pos), **kw)
    to, tc = layers.apply_gqa(tpa, _t(x), cfg, kind="prefill",
                              positions=_t(pos), **kw)
    _close(to, jo, 1e-5)
    for key in ("k", "v"):
        _close(tc[key], jc[key], 1e-5)
    # decode the token at position s into a cache of capacity s + 2
    xd = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    cache = {key: np.pad(np.asarray(jc[key]), ((0, 0), (0, 2), (0, 0),
                                                (0, 0))) for key in jc}
    jo, jc2 = jlayers.apply_gqa(
        jpa, jnp.asarray(xd), jm.cfg, kind="decode",
        positions=jnp.full((b, 1), s), cache=jax.tree.map(jnp.asarray, cache),
        index=jnp.int32(s), **kw)
    tcache = {key: _t(v) for key, v in cache.items()}
    to, tc2 = layers.apply_gqa(tpa, _t(xd), cfg, kind="decode",
                               positions=torch.full((b, 1), s), cache=tcache,
                               index=s, **kw)
    _close(to, jo, 1e-5)
    assert tc2["k"] is tcache["k"]  # written in place
    for key in ("k", "v"):
        _close(tc2[key], jc2[key], 1e-5)


def test_prefill_matches_jax(pair):
    """Logits within atol/rtol 1e-4.  Cache leaves within 1e-4 of their
    largest magnitude (`_close`): on these random weights the JAX
    package's own f32 cache lies up to 2.6e-4 from a float64 evaluation
    of the same model (attention logits reach a few hundred before the
    softcap), so an element-wise 1e-4 would test f32 rounding rather than
    the port."""
    jm, jp, tm = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(_t(toks).long())
    assert tl.shape == (2, 40, jm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jleaves = jax.tree.leaves(jc)
    tleaves = tree_leaves(tc)
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape)
                                                 for t in tleaves]
    for got, want in zip(tleaves, jleaves):
        _close(got, want, 1e-4)


def test_float64_evaluation_bounds_both_f32_routes(pair):
    """The port's float64 evaluation of the same parameters: the port's
    and the JAX package's f32 prefills both lie within f32 noise of it
    (logits 1e-4; cache leaves 1e-4 of their magnitude, see above)."""
    jm, jp, tm = pair
    t64 = Model(tm.cfg).load(tree_map(lambda t: t.double(), tm.params))
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (2, 40))
    l64, c64 = t64.prefill(_t(toks))
    assert l64.dtype == torch.float64
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(_t(toks))
    for logits, cache in ((tl.numpy(), tree_leaves(tc)),
                          (np.asarray(jl), jax.tree.leaves(jc))):
        assert np.abs(logits - l64.numpy()).max() < 1e-4
        for got, want in zip(cache, tree_leaves(c64)):
            _close(want, np.asarray(got, np.float64), 1e-4)


def test_decode_matches_full_forward(pair):
    """As `tests/test_models.py::test_decode_matches_full_forward`."""
    _, _, tm = pair
    rng = np.random.default_rng(1)
    b, s = 2, 24
    toks = _t(rng.integers(0, tm.cfg.vocab_size, (b, s)))
    full, _ = tm.prefill(toks)
    s0 = s // 2
    _, cache = tm.prefill(toks[:, :s0])
    cache = tm.pad_cache(cache, b, s, torch.float32)
    errs = []
    for t in range(s0, s):
        ln, cache = tm.decode_step(cache, toks[:, t], t)
        errs.append(float((ln - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, max(errs)


@pytest.mark.parametrize("call", ["params_from_jax", "init_cache"])
def test_default_device_is_the_card(call):
    """With no device asked, the port runs on the card; with no card it
    raises instead of carrying on on the CPU."""
    from repro_torch.models import lm

    def run():
        if call == "params_from_jax":
            return params_from_jax({"w": np.zeros((2, 3), np.float32)})["w"]
        return tree_leaves(lm.init_cache(configs.get_smoke_config(ARCH), 1,
                                         8))[0]
    if torch.cuda.is_available():
        assert run().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            run()
