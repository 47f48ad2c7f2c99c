"""The port's ServeEngine and serving launcher (gemma2 smoke configuration,
plain PyTorch route on the CPU) against the JAX package's ServeEngine on
the same converted parameters."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "gemma2_9b"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    jm = JModel(jget_smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(3), jnp.float32)
    tm = Model(configs.get_smoke_config(ARCH)).load(
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, jp, tm


def _requests(vocab):
    """Three length buckets (one longer than max_batch rows), prompts
    longer than local_window = 16 so the window applies in prefill and
    decode."""
    rng = np.random.default_rng(5)
    return [rng.integers(1, vocab, n).tolist()
            for n in (21, 5, 21, 40, 21, 5, 21)]


@pytest.mark.parametrize("eos", [None, "first"])
def test_serve_matches_jax(models, eos):
    jm, jp, tm = models
    reqs = _requests(jm.cfg.vocab_size)
    kw = dict(max_batch=3, max_seq=64)
    eos_id = None
    if eos == "first":  # a token the greedy chains emit: some waves stop
        eos_id = JServeEngine(jm, jp, **kw).serve(reqs[:1], max_new=12)[0][3]
    jeng = JServeEngine(jm, jp, eos_id=eos_id, **kw)
    teng = ServeEngine(tm, eos_id=eos_id, **kw)
    want = jeng.serve(reqs, max_new=12)
    got = teng.serve(reqs, max_new=12)
    assert got == want
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    if eos_id is not None:
        assert teng.stats.generated_tokens < 12 * len(reqs)


def test_serve_rejects_tokens_outside_vocab(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="prompt tokens"):
        ServeEngine(tm).serve([[1, tm.cfg.padded_vocab]], max_new=2)


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert re.fullmatch(r"16 requests in [\d.]+s, [\d.]+ tok/s, "
                        r"waves=\d+\n", proc.stdout)


def test_launcher_defaults():
    args = launcher.build_parser().parse_args(["--arch", ARCH])
    assert (args.requests, args.max_new, args.max_batch, args.max_seq,
            args.device, args.dtype) == (16, 32, 8, 256, "cuda", None)
    eng = launcher.make_engine(launcher.build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu"]))
    assert eng.dtype == torch.float32
    assert eng.model.params["embed"].dtype == torch.float32
    reqs = launcher.make_requests(eng.model.cfg, 16)
    assert len(reqs) == 16 and all(4 <= len(r) < 64 for r in reqs)


def test_launcher_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", ARCH, "--smoke"])
