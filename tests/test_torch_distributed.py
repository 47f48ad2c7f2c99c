"""The port's distributed build (`repro_torch.core.build_bisim_distributed`
over a gloo process group on the CPU) against the JAX package's
(`repro.core.build_bisim_distributed` over a mesh of fake CPU devices),
at the same number of ranks as devices.

The reference's results are computed once, in a subprocess with eight
fake devices (as `tests/test_distributed.py` runs it); the port's by D
ranks of `python -c`, each started with torchrun's variables, so every
group also goes through `launch.cluster.init_cluster` (D = 1 runs in this
process, through its one-rank group).  Everything is integers, so the bar
is equality: pid histories, counts, ``converged_at``, ``k_requested``, the
`IterationStats` integer columns and the overflow error, in all three
modes with both rankings at D = 1, 2, 4 and 8, on the five edge cases of
`tests/test_distributed.py` at D = 8 and against its (2, 2, 2) mesh run.
Then `shard_graph`'s arrays, the launcher's ``--distributed`` lines and
``--out`` pids against the reference launcher's, its refusals, and where
the build runs.
"""
import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.core import distributed as ref_dist
from repro.graph import generators as rgen
from repro.graph.storage import Graph as RefGraph
from repro.launch import bisim as ref_launcher

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from repro_torch.core import build_bisim_distributed, shard_graph  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.storage import Graph  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402
from repro_torch.launch import cluster  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODES = ["sorted", "dedup_hash", "multiset"]
RANKINGS = ["allgather", "bucketed"]
GROUPS = [1, 2, 4, 8]
STAT_COLUMNS = ("iteration", "num_partitions", "bytes_sorted",
                "bytes_scanned")

# The cases of one group of D ranks, shared by both packages' scripts
# (their generators and `Graph` take the same arguments and give the
# same graphs): the sweep of `tests/test_distributed.py:21-38` at every
# D; at D = 8 its five edge cases (`:50-57`) and its mesh graph (`:71-91`,
# which the reference runs on a (2, 2, 2) mesh); at D = 2 a bucket
# capacity that overflows.
CASES = textwrap.dedent('''
    import numpy as np

    def cases(d):
        g = gen.random_graph(500, 2000, 3, 2, seed=3)
        out = [(f"d{d}/{m}/{r}", g, 8, dict(mode=m, ranking=r))
               for m in ("sorted", "dedup_hash", "multiset")
               for r in ("allgather", "bucketed")]
        if d == 8:
            edge = [gen.powerlaw_graph(300, 3000, seed=1),
                    gen.kary_tree(3, 5), gen.complete_graph(20),
                    Graph(np.zeros(5, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.int32), np.zeros(0, np.int32)),
                    gen.random_graph(7, 11, 2, 2, seed=2)]
            out += [(f"edge{i}", e, 6, dict(mode="sorted",
                                            ranking="bucketed",
                                            capacity_factor=8.0))
                    for i, e in enumerate(edge)]
            out.append(("mesh", gen.random_graph(200, 800, 3, 2, seed=5), 5,
                        dict(mode="dedup_hash", ranking="bucketed")))
        if d == 2:
            out.append(("overflow", gen.random_graph(10000, 30000, 3, 2,
                                                     seed=0), 4,
                        dict(mode="sorted", ranking="bucketed",
                             capacity_factor=0.5)))
        return out

    def pack(key, build):
        """A result (or the build's RuntimeError) as npz members."""
        try:
            res = build()
        except RuntimeError as e:
            return {f"{key}/error": np.array(str(e))}
        st = np.array([[getattr(s, c) for c in ("iteration",
                       "num_partitions", "bytes_sorted", "bytes_scanned")]
                       for s in res.stats], np.int64)
        return {f"{key}/pids": res.pids, f"{key}/counts":
                np.array(res.counts), f"{key}/stats": st,
                f"{key}/meta": np.array([
                    -1 if res.converged_at is None else res.converged_at,
                    res.k_requested])}
''')

REF_SCRIPT = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax
    from repro.graph import generators as gen
    from repro.graph.storage import Graph
    from repro.core.distributed import build_bisim_distributed, make_flat_mesh
''') + CASES + textwrap.dedent('''
    out = {}
    for d in (1, 2, 4, 8):
        flat = make_flat_mesh(jax.devices()[:d])
        for key, g, k, kw in cases(d):
            mesh = dict(mesh=flat)
            if key == "mesh":
                mesh = dict(mesh=jax.make_mesh((2, 2, 2),
                                               ("pod", "data", "model")),
                            axis=("pod", "data", "model"))
            out.update(pack(key, lambda: build_bisim_distributed(
                g, k, **mesh, **kw)))
    np.savez(sys.argv[1], **out)
''')

PORT_SCRIPT = textwrap.dedent('''
    import sys
    sys.path.insert(0, "src")
    from repro_torch.core import build_bisim_distributed
    from repro_torch.graph import generators as gen
    from repro_torch.graph.storage import Graph
    from repro_torch.launch.cluster import init_cluster
''') + CASES + textwrap.dedent('''
    rank, d = init_cluster(device="cpu")
    out = {}
    for key, g, k, kw in cases(d):
        out.update(pack(key, lambda: build_bisim_distributed(
            g, k, device="cpu", **kw)))
    np.savez(f"{sys.argv[1]}.rank{rank}.npz", **out)
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


def _spawn_ranks(argv: list, d: int, **env) -> list:
    """D processes of ``argv`` with torchrun's variables for a group of D
    ranks on this host."""
    port = _free_port()
    return [subprocess.Popen(
        argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(RANK=r, WORLD_SIZE=d, LOCAL_RANK=r,
                            LOCAL_WORLD_SIZE=d, MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=port, **env))
            for r in range(d)]


def _wait(procs: list) -> list:
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    return [out for out, _ in outs]


def _unpack(z, key) -> dict:
    return {name.split("/")[-1]: z[name] for name in z.files
            if name.rsplit("/", 1)[0] == key}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results, every case: {case key: (reference, port)},
    the port's from rank 0 (after checking every rank got the same)."""
    tmp = tmp_path_factory.mktemp("dist")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            str(tmp / "ref.npz")], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=_env())
    ports = {}
    for d in GROUPS[1:]:
        ports[d] = _spawn_ranks([sys.executable, "-c", PORT_SCRIPT,
                                 str(tmp / f"d{d}")], d)
        _wait(ports[d])
    _wait([ref])
    got = {}
    with np.load(tmp / "ref.npz") as z:
        want = {key: _unpack(z, key) for key in
                {n.rsplit("/", 1)[0] for n in z.files}}
    for d in GROUPS[1:]:
        ranks = [np.load(tmp / f"d{d}.rank{r}.npz") for r in range(d)]
        for key in {n.rsplit("/", 1)[0] for n in ranks[0].files}:
            first = _unpack(ranks[0], key)
            for other in ranks[1:]:
                theirs = _unpack(other, key)
                assert all(np.array_equal(first[f], theirs[f])
                           for f in first), (d, key)
            got[key] = first
    return {key: (want[key], got.get(key)) for key in want}


def _one_rank_group():
    """A one-rank gloo group in this process (`init_cluster` without
    torchrun's or Slurm's variables)."""
    for var in ("RANK", "WORLD_SIZE", "SLURM_JOB_NODELIST"):
        assert var not in os.environ, var
    return cluster.init_cluster(device="cpu")


def _pack(res) -> dict:
    return {"pids": res.pids, "counts": np.array(res.counts),
            "stats": np.array([[getattr(s, c) for c in STAT_COLUMNS]
                               for s in res.stats], np.int64),
            "meta": np.array([-1 if res.converged_at is None
                              else res.converged_at, res.k_requested])}


def _assert_same(want: dict, got: dict) -> None:
    assert got is not None
    assert sorted(got) == sorted(want)
    for field in want:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)


@pytest.mark.parametrize("ranking", RANKINGS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", GROUPS)
def test_sweep_matches_reference(runs, d, mode, ranking):
    """`random_graph(500, 2000, 3, 2, seed=3)`, k=8: bit for bit the
    reference's pids, counts, convergence and byte columns at D = d."""
    want, got = runs[f"d{d}/{mode}/{ranking}"]
    if d == 1:
        g = gen.random_graph(500, 2000, 3, 2, seed=3)
        assert _one_rank_group() == (0, 1)
        try:
            got = _pack(build_bisim_distributed(g, 8, mode=mode,
                                                ranking=ranking,
                                                device="cpu"))
        finally:
            dist.destroy_process_group()
    _assert_same(want, got)
    n_pad = -(-(500 + 1) // d) * d
    assert (got["stats"][1:, 3] == 8 * n_pad).all()


@pytest.mark.parametrize("case", [f"edge{i}" for i in range(5)] + ["mesh"])
def test_edge_cases_and_mesh_match_reference(runs, case):
    """D = 8, ``sorted``, ``bucketed``, capacity factor 8: hubs, a k-ary
    tree, a complete graph, no edges, n < 2D; and the reference's
    (2, 2, 2) ``("pod", "data", "model")`` mesh run against 8 ranks."""
    _assert_same(*runs[case])


def test_overflow_error_matches_reference(runs):
    """A bucket capacity below the load raises the reference's
    RuntimeError, with its count of dropped elements, on every rank."""
    want, got = runs["overflow"]
    assert str(got["error"]) == str(want["error"])
    assert re.fullmatch(r"bucketed ranking overflow \(\d+ elements\); "
                        r"increase capacity_factor \(> 0\.5\)",
                        str(got["error"]))


@pytest.mark.parametrize("d", GROUPS)
@pytest.mark.parametrize("graph", ["random", "powerlaw", "empty", "tiny"])
def test_shard_graph_matches_reference(graph, d):
    make = {"random": lambda m: m.random_graph(500, 2000, 3, 2, seed=3),
            "powerlaw": lambda m: m.powerlaw_graph(300, 3000, seed=1),
            "tiny": lambda m: m.random_graph(7, 11, 2, 2, seed=2)}
    if graph == "empty":
        z = np.zeros(0, np.int32)
        ref_g = RefGraph(np.zeros(5, np.int32), z, z, z)
        g = Graph(np.zeros(5, np.int32), z, z, z)
    else:
        ref_g, g = make[graph](rgen), make[graph](gen)
    want = ref_dist.shard_graph(ref_g, d)
    got = shard_graph(g, d)
    for field in ("node_labels", "pid0", "src_local", "dst", "elabel",
                  "valid"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in ("num_nodes", "n_pad", "n_loc", "e_loc", "num_devices",
                  "num_pid0", "has_padding"):
        assert getattr(got, field) == getattr(want, field), field


_MS = re.compile(r"\s+[\d.]+ ms ")
_TOTAL = re.compile(r"^total [\d.]+s;")


def _strip_times(text: str) -> list:
    return [_TOTAL.sub("total Xs;", _MS.sub(" X ms ", ln))
            for ln in text.splitlines()
            if not ln.startswith("saved pid history")]


def test_launcher_distributed_matches_reference(tmp_path):
    """``--distributed --ranking bucketed --generator structured``: 8 ranks
    of the port's launcher print the reference launcher's lines on 8 fake
    devices (ms and seconds apart), rank 0 alone, and save its pids."""
    common = ["--distributed", "--ranking", "bucketed", "--generator",
              "structured", "--nodes", "3000", "--k", "6"]
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.bisim", *common, "--out",
         str(tmp_path / "ref.npz")], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert ref.returncode == 0, ref.stdout + ref.stderr
    outs = _wait(_spawn_ranks(
        [sys.executable, "-m", "repro_torch.launch.bisim", "--device", "cpu",
         *common, "--out", str(tmp_path / "mine.npz")], 8))
    assert all(out == "" for out in outs[1:])
    assert _strip_times(outs[0]) == _strip_times(ref.stdout)
    assert "k=6 mode=sorted dist/bucketed" in outs[0]
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "mine.npz") as b:
        np.testing.assert_array_equal(b["pids"], a["pids"])


@pytest.mark.parametrize("argv", [["add-edges", "--count", "3"],
                                  ["materialize", "--quotient-dir", "{q}"]])
def test_launcher_refuses_store_subcommands(capsys, tmp_path, argv):
    """The distributed builder keeps no store: the maintenance and
    quotient subcommands refuse it with the reference's message."""
    argv = ["--distributed", "--generator", "random", "--nodes", "50",
            "--edges", "100"] + [a.format(q=tmp_path / "q") for a in argv]
    with pytest.raises(SystemExit) as ref_exit:
        ref_launcher._dispatch(ref_launcher.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as mine:
        launcher.main(["--device", "cpu"] + argv)
    assert str(mine.value) == str(ref_exit.value)
    assert "the distributed builder keeps no store" in str(mine.value)
    assert not dist.is_initialized()


def test_launcher_refuses_distributed_oocore(capsys):
    argv = ["--distributed", "--oocore"]
    with pytest.raises(SystemExit) as ref_exit:
        ref_launcher.build_parser().parse_args(argv)
    ref_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as mine:
        launcher.main(["--device", "cpu"] + argv)
    assert mine.value.code == ref_exit.value.code == 2
    assert "not allowed with argument --distributed" in ref_err
    assert "not allowed with argument --distributed" in \
        capsys.readouterr().err


def test_launcher_one_rank_starts_and_stops_its_group(capsys):
    """Without torchrun's variables ``--distributed`` is one rank in this
    process: the D = 1 build, whose pids equal ``allgather``'s at any D
    (the padding nodes form one block), and no group left behind."""
    res = launcher.main(["--device", "cpu", "--distributed", "--generator",
                         "random", "--nodes", "300", "--edges", "900",
                         "--k", "4", "--ranking", "bucketed"])
    assert not dist.is_initialized()
    assert "k=4 mode=sorted dist/bucketed" in capsys.readouterr().out
    ref = launcher.main(["--device", "cpu", "--generator", "random",
                         "--nodes", "300", "--edges", "900", "--k", "4"])
    assert res.counts == ref.counts
    assert res.converged_at == ref.converged_at


def test_build_needs_a_process_group():
    g = gen.random_graph(50, 100, 3, 2, seed=0)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        build_bisim_distributed(g, 2, device="cpu")


def test_build_runs_on_the_card_unless_cpu_is_asked(monkeypatch):
    g = gen.random_graph(50, 100, 3, 2, seed=0)
    _one_rank_group()
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                build_bisim_distributed(g, 2, device=device)
        with pytest.raises(ValueError, match="sharded for 2 ranks"):
            build_bisim_distributed(g, 2, device="cpu",
                                    sharded=shard_graph(g, 2))
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.init_cluster()
    assert not dist.is_initialized()


def test_init_cluster_reads_slurm(monkeypatch):
    """Slurm's variables: the first host of the node list and the
    reference's coordinator port (``MASTER_PORT`` overrides it)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_JOB_NODELIST", "localhost")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_LOCALID", "0")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert cluster.init_cluster(device="cpu") == (0, 1)
        assert dist.get_backend() == "gloo"
        assert os.environ["LOCAL_RANK"] == "0"
        # a running group is returned as it is
        assert cluster.init_cluster(device="cpu") == (0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        os.environ.pop("LOCAL_RANK", None)


@pytest.mark.parametrize("nodelist,host", [
    ("node7", "node7"), ("gpu[07-09,12],cpu1", "gpu07"), ("a,b", "a"),
    ("n[3]", "n3"), ("rack1-n[10,11]", "rack1-n10")])
def test_first_slurm_host(nodelist, host):
    assert cluster._first_host(nodelist) == host


def test_backends_are_explicit(monkeypatch):
    assert cluster.default_backend("cpu") == "gloo"
    assert cluster.default_backend("cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        cluster.default_backend("cpu", "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        cluster.default_backend("cpu", "mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cluster.default_backend("cuda") == "nccl"
    assert cluster.default_backend("cuda", "gloo") == "gloo"
