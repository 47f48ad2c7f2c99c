"""The plain reference against the program's CPU route and the paper's
example.  The test may import both; the reference imports nothing of the
program (`test_bench_imports.py`)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import checks, registry
from bench.reference import bisim as reference
from bench.tests.test_bench_gen import small
from repro_torch.core.partition import build_bisim
from repro_torch.graph import generators
from repro_torch.graph.storage import Graph, paper_example_graph


def cols_of(g: Graph) -> dict:
    return {"node_labels": torch.from_numpy(g.node_labels),
            "src": torch.from_numpy(g.src), "dst": torch.from_numpy(g.dst),
            "elabel": torch.from_numpy(g.elabel)}


def graph_of(cols: dict) -> Graph:
    return Graph(**{k: v.numpy() for k, v in cols.items()})


def assert_same(res, ref):
    assert res.counts == ref.counts
    assert res.converged_at == ref.converged_at
    assert checks.partition_gap(res.pids, ref.pids, "cpu") == 0


def test_paper_example():
    """Table 1: {1,2},{3,5},{4},{6} at k=1; {3,5} still together at k=2."""
    ref = reference.partition(cols_of(paper_example_graph()), 2,
                              early_stop=False)
    assert ref.counts == [2, 4, 5]
    p1, p2 = (r.numpy() for r in ref.pids[1:])
    assert p1[0] == p1[1] and p1[2] == p1[4]
    assert len({p1[0], p1[2], p1[3], p1[5]}) == 4
    assert p2[2] == p2[4] and len(set(p2.tolist())) == 5


@pytest.mark.parametrize("name", ["graph500-s25"])
@pytest.mark.parametrize("semantics,mode", [("set", "sorted"),
                                            ("multiset", "multiset")])
def test_generated_graphs(name, semantics, mode):
    cfg = small(name)
    cols = registry.generator(cfg["generator"]).generate(cfg, 17, "cpu")
    res = build_bisim(graph_of(cols), 10, mode=mode, device="cpu")
    assert_same(res, reference.partition(cols, 10, semantics=semantics))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("early_stop", [True, False])
def test_random_graphs(seed, early_stop):
    g = generators.random_graph(400, 1500, 3, 2, seed=seed)
    res = build_bisim(g, 6, early_stop=early_stop, device="cpu")
    assert_same(res, reference.partition(cols_of(g), 6,
                                         early_stop=early_stop))


def test_long_rows():
    """A complete graph's rows are as long as it has nodes, with three
    edge labels among them."""
    g = generators.complete_graph(70)
    lab = np.arange(g.num_edges, dtype=np.int32) % 3
    g = Graph.from_edges(g.node_labels, g.src, g.dst, lab)
    res = build_bisim(g, 4, device="cpu")
    assert_same(res, reference.partition(cols_of(g), 4))


def test_mix_is_a_bijection_on_a_range():
    """splitmix64's finaliser maps distinct pairs to distinct words."""
    x = torch.arange(-(1 << 20), 1 << 20, dtype=torch.int64)
    for salt in reference.SALTS:
        assert torch.unique(reference.mix(x, salt)).numel() == x.numel()


def test_a_set_is_named_whatever_the_order_of_its_pairs():
    key = torch.tensor([5, 9, 12, (1 << 4) | 3, (1 << 4) | 7])
    a = reference._signatures(key, 4, 2)
    b = reference._signatures(key.flip(0), 4, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].tolist() == [3, 2]


def test_set_and_multiset_differ_where_edges_repeat_a_pair():
    cfg = small("graph500-s25")
    cols = registry.generator("kronecker").generate(cfg, 3, "cpu")
    a = reference.partition(cols, 10)
    b = reference.partition(cols, 10, semantics="multiset")
    assert checks.partition_gap(a.pids, b.pids, "cpu") > 0
