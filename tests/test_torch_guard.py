"""Guards of the port: what it may import, where it runs, how it starts."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from repro_torch import resolve_device  # noqa: E402
from repro_torch.launch import bisim as launcher  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    banned = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not banned, f"{path.name} imports {sorted(banned)}"


def _slice_is_guarded(modules) -> None:
    """``modules`` (paths under ``src/repro_torch``) are among the scanned
    files, and importing them pulls in neither JAX nor the JAX package,
    however indirectly (a fresh interpreter in which both are
    unimportable)."""
    port = ROOT / "src" / "repro_torch"
    for rel in modules:
        assert port / rel in PORT_FILES, rel
    names = ["repro_torch." + rel[:-3].replace("/", ".") for rel in modules]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            + "".join(f"import {n}\n" for n in names))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


TRAINING_MODULES = ["train/trainer.py", "optim/adamw.py",
                    "optim/compression.py", "checkpoint/manager.py",
                    "data/pipeline.py", "models/flash_xla.py",
                    "launch/train.py"]


def test_training_slice_is_guarded():
    _slice_is_guarded(TRAINING_MODULES)


MESH_MODULES = ["launch/mesh.py", "launch/roofline.py", "launch/hlo_stats.py",
                "launch/dryrun.py", "models/config.py", "models/model.py",
                "models/params.py", "train/trainer.py"]


def test_mesh_slice_is_guarded():
    _slice_is_guarded(MESH_MODULES)


MOE_MODULES = ["models/moe.py", "models/blocks.py", "models/layers.py",
               "configs/llama4_scout_17b_16e.py",
               "configs/deepseek_v2_lite_16b.py"]


def test_moe_slice_is_guarded():
    """The MoE slice's modules, as the training and mesh slices'; both
    MoE architectures resolve through the registry."""
    _slice_is_guarded(MOE_MODULES)
    from repro_torch.configs import ARCH_IDS, get_config
    for arch in ("llama4_scout_17b_16e", "deepseek_v2_lite_16b"):
        assert arch in ARCH_IDS and get_config(arch).family == "moe"


def test_resolve_device_never_falls_back(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(asked)


def test_launcher_defaults_match_reference():
    from repro.launch.bisim import build_parser as ref_parser
    mine = vars(launcher.build_parser().parse_args([]))
    theirs = vars(ref_parser().parse_args([]))
    assert mine.pop("device") == "cuda"
    # declared divergence: maintenance propagates on the device unless
    # --host-maintenance asks for the host (the reference opts in)
    assert mine.pop("device_maintenance") is True
    assert theirs["device_maintenance"] is False
    # declared divergence: the port's own --dist-backend picks the process
    # group's backend (nccl on the card, gloo with --device cpu)
    assert mine.pop("dist_backend") is None
    assert "dist_backend" not in theirs
    for key, value in mine.items():
        assert theirs[key] == value, key


def test_launcher_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "pids.npz"
    trace = tmp_path / "trace.json"
    launcher.main(["--device", "cpu", "--generator", "random", "--nodes",
                   "300", "--edges", "900", "--k", "4", "--out", str(out),
                   "--trace", str(trace)])
    text = capsys.readouterr().out
    assert re.search(r"^graph: 300 nodes, \d+ edges$", text, re.M)
    assert "k=4 mode=sorted single" in text
    assert re.search(r"^  iter  0: +4 blocks +[\d.]+ ms  sortedB=1200 "
                     r"scannedB=1200$", text, re.M)
    assert re.search(r"^total [\d.]+s; converged_at=\d+$", text, re.M)
    assert f"saved pid history to {out}" in text
    assert re.search(r"^events: build.copy=\d+ build.dispatch=\d+ "
                     r"build.sync=\d+$", text, re.M)
    assert out.exists() and trace.exists()


def test_launcher_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--nodes", "10", "--edges", "10"])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a card it exits non-zero and prints no result, in the
    checkout and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
