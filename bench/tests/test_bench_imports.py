"""Nothing under `bench/` imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program either."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(BENCH).as_posix() for p in MODULES])
def test_no_jax_or_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    if path.parent.name == "tests" and path.name == "test_bench_imports.py":
        found = set()  # this file names them only to look for them
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax"}


def test_scan_sees_imports():
    """The scan is no blind one: it finds the names where they are."""
    names = top_level_imports(BENCH / "harness.py")
    assert {"torch", "bench", "repro_torch"} <= names
    assert "repro" not in names  # `repro_torch` is not `repro`


def test_run_loads_no_jax(tmp_path):
    """`bench/run.py`'s imports, in a fresh interpreter, load none of them
    (the harness checks `sys.modules` again after every window)."""
    import subprocess
    import sys
    code = ("import runpy, sys; sys.argv = ['run.py', '--help'];\n"
            "try:\n runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit:\n pass\n"
            "import bench.harness as h, repro_torch.core.partition\n"
            "print(h.forbidden(sys.modules))") % str(BENCH / "run.py")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
