"""The graph family: deterministic in the seed, the specification's draw,
the configuration's node count and distinct, canonical edges at a small
scale."""
from __future__ import annotations

import json

import pytest
import torch

from bench import graphs, registry
from bench.tests.toy import REPO

CONFIGS = {"graph500-s25": {"scale": 10}}


def small(name: str) -> dict:
    cfg = json.loads((REPO / "bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(CONFIGS[name])
    return cfg


@pytest.mark.parametrize("name", list(CONFIGS))
def test_deterministic_in_the_seed(name):
    cfg = small(name)
    gen = registry.generator(cfg["generator"])
    seed = 2 ** 31 + 12345  # wider than 32 signed bits
    a, b = gen.generate(cfg, seed, "cpu"), gen.generate(cfg, seed, "cpu")
    c = gen.generate(cfg, seed + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in graphs.COLUMNS)
    assert not all(torch.equal(a[k], c[k]) if a[k].shape == c[k].shape
                   else False for k in graphs.COLUMNS)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_counts_and_canonical_order(name):
    cfg = small(name)
    gen = registry.generator(cfg["generator"])
    cols = gen.generate(cfg, 5, "cpu")
    s = gen.sizes(cfg)
    n = s["nodes"]
    assert cols["node_labels"].numel() == n == 2 ** cfg["scale"]
    assert all(cols[k].dtype == torch.int32 for k in graphs.COLUMNS)
    e = cols["src"].numel()
    # duplicate draws go; at scale 10 about a fifth of them
    assert 0.7 * s["edges_drawn"] < e < s["edges_drawn"]
    assert not bool(cols["elabel"].any())  # unlabelled: one edge label
    key = cols["src"].long() * n + cols["dst"].long()
    assert bool((key[1:] > key[:-1]).all())  # sorted and distinct
    assert int(cols["src"].max()) < n and int(cols["dst"].max()) < n


def test_quadrants_follow_the_initiator():
    """One bit a draw: (start, end) is (0, 0), (0, 1), (1, 0) or (1, 1)
    with the initiator's A, B, C and D."""
    cfg = small("graph500-s25")
    gen = registry.generator("kronecker")
    g = torch.Generator().manual_seed(3)
    i, j = gen._bits(g, 1_000_000, 1, cfg["initiator"], "cpu")
    freq = torch.bincount(2 * i + j, minlength=4).double() / i.numel()
    assert torch.allclose(freq, torch.tensor(cfg["initiator"],
                                             dtype=torch.float64), atol=3e-3)


def test_vertices_are_renamed():
    """Without the permutation vertex 0 would start the most edges; with
    it the heaviest start lies anywhere, and moves with the seed."""
    cfg = small("graph500-s25")
    gen = registry.generator("kronecker")
    heaviest = {int(torch.bincount(gen.generate(cfg, s, "cpu")["src"])
                    .argmax()) for s in range(4)}
    assert len(heaviest) > 1


def test_full_config_is_the_specification_cut_once():
    """The specification's initiator and edgefactor; SCALE one below its
    toy class, 26, and the cut named in ``reduced``."""
    cfg = json.loads((REPO / "bench/configs/graph500-s25.json").read_text())
    assert (cfg["scale"], cfg["edgefactor"]) == (25, 16)
    assert cfg["published"]["scale"] == 26 and cfg["reduced"] == ["scale"]
    assert cfg["initiator"] == [0.57, 0.19, 0.19, 0.05]
    s = registry.generator("kronecker").sizes(cfg)
    assert (s["nodes"], s["edges_drawn"]) == (33_554_432, 536_870_912)
