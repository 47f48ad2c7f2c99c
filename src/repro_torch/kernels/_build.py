"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain-C interface and compiles, at first use,
into ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(the digest covers the source and the flags, so an edited source builds
anew).  ``nvcc``'s ``-Xptxas -v`` report is kept beside the library.  No
PyTorch header is included, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# argtypes of every entry point, by library
SIGNATURES = {
    "sig_fold": {
        "sig_fold_flat": [_P] * 6 + [_LL, _LL, _I, _I, _P],
        "sig_fold_bitonic": [_P] * 6 + [_LL, _LL, _I, _P],
    },
    "chunk_sig_fold": {
        "chunk_sig_fold": [_P] * 6 + [_LL, _I, _I, _I, _P],
    },
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> dict:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once.  Returns {name: library path}; raises with
    ``nvcc``'s output if one fails."""
    paths = {name: library_path(name) for name in names}
    started = {}
    for name, out in paths.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        started[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        paths[name].with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, paths[name])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v``'s lines for a built library."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one library, with typed entry points."""
    lib = ctypes.CDLL(str(build(name)[name]))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
