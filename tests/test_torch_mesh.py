"""The port's logical axes and mesh rules (`repro_torch.launch.mesh`,
`models.{params,model,config}`) against the JAX package's.

`resolve_spec` of both packages reads only ``mesh.shape``, so a stand-in
with that dict serves for the 16x16 and 2x16x16 production meshes: no
device of 256 or 512 is made.  Every leaf of `param_axes`, `cache_axes`
and `input_specs`' axes is resolved by both, at full config, for every
shape's rules; the reference's ``PartitionSpec`` entries (None, a name, a
tuple of names) read as the port's tuples of names.
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.launch import mesh as ref_mesh
from repro.models import config as ref_cfgmod
from repro.models.model import Model as RefModel
from repro.models.model import model_flops as ref_model_flops

torch = pytest.importorskip("torch")
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models import config as cfgmod  # noqa: E402
from repro_torch.models.model import Model, model_flops  # noqa: E402
from repro_torch.models.params import ParamSpec  # noqa: E402

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
SHAPES = list(ref_cfgmod.SHAPES)


def _stand_in(sizes: dict):
    return types.SimpleNamespace(shape=dict(sizes))


def _ref_entry(e) -> tuple:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _walk(axes, shapes, prefix=""):
    """(path, axes tuple, shape) of parallel nested-dict trees."""
    if isinstance(axes, dict):
        assert sorted(axes) == sorted(shapes), prefix
        for k in sorted(axes):
            yield from _walk(axes[k], shapes[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], axes, tuple(shapes.shape)


def _trees(arch: str, shape_name: str):
    """Both packages' (axes, shapes) trees of the parameters and the
    inputs (the cache among them) of one cell."""
    shape = ref_cfgmod.SHAPES[shape_name]
    ref, port = RefModel(ref_config(arch)), Model(get_config(arch))
    r_in, r_ax = ref.input_specs(shape, jnp.bfloat16)
    p_in, p_ax = port.input_specs(cfgmod.SHAPES[shape_name])
    return ((ref.param_axes(), ref.param_shapes(jnp.bfloat16), r_ax, r_in),
            (port.param_axes(), port.param_shapes(), p_ax, p_in))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference(arch, shape_name, mesh_name):
    mesh = _stand_in(MESHES[mesh_name])
    ref_rules = ref_mesh.rules_for_shape(shape_name)
    rules = meshlib.rules_for_shape(shape_name)
    assert rules == ref_rules
    (r_pax, r_psh, r_iax, r_ish), (p_pax, p_psh, p_iax, p_ish) = _trees(
        arch, shape_name)
    leaves = 0
    for (r_ax, r_sh), (p_ax, p_sh) in (((r_pax, r_psh), (p_pax, p_psh)),
                                       ((r_iax, r_ish), (p_iax, p_ish))):
        want = list(_walk(r_ax, r_sh))
        got = list(_walk(p_ax, p_sh))
        assert [(p, a, s) for p, a, s in got] == [
            (p, tuple(a), s) for p, a, s in want]
        for (path, axes, shp), _ in zip(got, want):
            ref_spec = ref_mesh.resolve_spec(axes, shp, mesh, ref_rules)
            spec = meshlib.resolve_spec(axes, shp, mesh, rules)
            assert spec == tuple(_ref_entry(e) for e in ref_spec), path
            leaves += 1
    assert leaves > 10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_counts_and_flops_match_reference(arch):
    ref, port = RefModel(ref_config(arch)), Model(get_config(arch))
    assert port.num_params() == ref.num_params()
    r_sh = {p: s for p, _, s in _walk(ref.param_axes(),
                                      ref.param_shapes(jnp.bfloat16))}
    p_sh = {p: s for p, _, s in _walk(port.param_axes(),
                                      port.param_shapes())}
    assert p_sh == r_sh
    assert all(t.dtype == torch.bfloat16 and t.device.type == "meta"
               for t in jax.tree.leaves(port.param_shapes()))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        port.param_shapes(torch.float32)))
    for name, shape in ref_cfgmod.SHAPES.items():
        mine = cfgmod.SHAPES[name]
        assert (mine.name, mine.seq_len, mine.global_batch, mine.kind) == (
            shape.name, shape.seq_len, shape.global_batch, shape.kind)
        assert cfgmod.supports_shape(port.cfg, mine) == \
            ref_cfgmod.supports_shape(ref.cfg, shape)
        assert model_flops(port.cfg, mine) == ref_model_flops(ref.cfg, shape)
        if shape.kind == "decode":
            r = jax.eval_shape(lambda: ref.init_cache(2, 8, jnp.bfloat16))
            c = port.cache_shapes(2, 8)
            assert {p: s for p, _, s in _walk(port.cache_axes(), c)} == {
                p: s for p, _, s in _walk(ref.cache_axes(), r)}


def test_param_spec_axes_and_defaults():
    """Axes default to none on every dim (the port's callers without
    axes keep working); a length mismatch raises."""
    assert ParamSpec((4, 5)).axes == (None, None)
    assert ParamSpec((3,), ("embed",)).axes == ("embed",)
    with pytest.raises(ValueError, match="differ in length"):
        ParamSpec((4, 5), ("embed",))


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), (), ("model",)), ["S0", "S0", "S2"]),
    (((), ("data",), ()), ["R", "S1", "R"]),
    (((), (), ()), ["R", "R", "R"]),
    ((("pod", "data", "model"),), ["S0", "S0", "S0"]),
])
def test_placements_for_follows_mesh_order(spec, want):
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = meshlib.placements_for(spec, mesh)
    names = [f"S{p.dim}" if isinstance(p, Shard) else "R"
             for p in got if isinstance(p, (Shard, Replicate))]
    assert names == want


def test_placements_for_refuses_an_order_the_mesh_cannot_split():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        meshlib.placements_for((("data", "pod"),), mesh)


def test_shard_is_a_no_op_outside_a_context():
    x = torch.zeros(4, 6)
    assert meshlib.shard(x, "act_batch", "act_embed") is x
    assert meshlib.active_mesh() is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_refuse_inputs_not_ported(arch):
    """No input is refused any more: a config flagged encoder-decoder
    takes the reference's frames [B, source_len, d_model] (a vlm keeps
    its patches, which the reference reads first), shapes and axes as
    the reference's; a decode takes its three inputs."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), is_encoder_decoder=True)
    ref = dataclasses.replace(ref_config(arch), is_encoder_decoder=True)
    r_in, r_ax = RefModel(ref).input_specs(ref_cfgmod.SHAPES["train_4k"],
                                           jnp.bfloat16)
    p_in, p_ax = Model(cfg).input_specs(cfgmod.SHAPES["train_4k"])
    assert list(p_in) == list(r_in)
    assert {k: tuple(t.shape) for k, t in p_in.items()} == {
        k: tuple(t.shape) for k, t in r_in.items()}
    assert p_ax == {k: tuple(v) for k, v in r_ax.items()}
    assert ("frames" in p_in) == (cfg.family != "vlm")
    np.testing.assert_equal(len(Model(get_config(arch)).input_specs(
        cfgmod.SHAPES["decode_32k"])[0]), 3)
