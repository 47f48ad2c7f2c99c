"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain-C interface and compiles, at first use,
into ``build/kernels/lib<name>-<digest>.so`` at the root of the checkout
(the digest covers the source, the ``csrc`` files it includes and the
flags, so an edited source or header builds anew).  ``nvcc``'s
``-Xptxas -v`` report is kept beside the library.  No
PyTorch header is included, so a build takes seconds.  A ``*_mla.cu``
source includes the attention source of its name and instantiates its
kernels at other head_dim pairs: a library of its own, built in parallel
with the rest.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
# argtypes of every entry point, by library
SIGNATURES = {
    "sig_fold": {  # four lane columns and the output, sizes, device
        "sig_fold_flat": [_P] * 5 + [_LL, _LL, _I, _I, _I, _I, _I, _P],
        "chunk_sig_fold": [_P] * 5 + [_LL, _I, _I, _I, _I, _I, _I, _P],
        "sig_fold_bitonic": [_P] * 5 + [_LL, _LL, _I, _I, _P],
    },
    # q, k, v, o, dims, the mask and softcap, q_offset, lse
    "flash_attention": {
        "flash_attention_fwd": [_P] * 4 + [ctypes.POINTER(_LL), _I, _I, _LL,
                                           _I, _F, _F, _LL, _P, _P],
    },
    "flash_attention_sm90": {
        "flash_attention_fwd_sm90": [_P] * 4 + [ctypes.POINTER(_LL), _I, _I,
                                                _LL, _I, _F, _F, _LL, _P, _P],
    },
    # q, k, v, o, lse, do, dq, dk, dv, delta scratch, dims, the mask and
    # softcap, q_offset (f32)
    "flash_attention_bwd": {
        "flash_attention_bwd": [_P] * 10 + [ctypes.POINTER(_LL), _I, _I, _LL,
                                             _I, _F, _F, _LL, _P],
    },
    # q, k, v, o, lse, do, dq, dk, dv, scratch, the plan's block table,
    # dims, the plan's scalars, the mask and softcap flags, softcap, scale
    # (bf16)
    "flash_attention_bwd_sm90": {
        "flash_attention_bwd_sm90": [_P] * 11 + [ctypes.POINTER(_LL),
                                                  ctypes.POINTER(_LL), _I, _I,
                                                  _I, _F, _F, _P],
    },
}
# each attention library's `*_mla` twin: the same entry points, named with
# the suffix, for the (q/k, v) head_dim pairs of MLA
for _name in ("flash_attention", "flash_attention_sm90", "flash_attention_bwd",
              "flash_attention_bwd_sm90"):
    SIGNATURES[f"{_name}_mla"] = {f"{fn}_mla": args for fn, args in
                                  SIGNATURES[_name].items()}
_INCLUDE = re.compile(r'^#include "([^"]+\.cuh?)"', re.M)
# wall seconds of each source's nvcc in the last `build` that compiled it
BUILD_SECONDS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` files it includes, directly or
    through another include, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for header in _INCLUDE.findall(path.read_text()):
            if CSRC / header not in found:
                found.append(CSRC / header)
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources(name))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> dict:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once (`BUILD_SECONDS` gets each one's wall seconds).
    Returns {name: library path}; raises with ``nvcc``'s output if one
    fails."""
    paths = {name: library_path(name) for name in names}
    started, logs = {}, {}
    t0 = time.perf_counter()
    for name, out in paths.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        started[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(name, proc):
        logs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - t0
    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (_, proc) in started.items()]
    for th in waiters:
        th.start()
    for th in waiters:
        th.join()
    failed = []
    for name, (tmp, proc) in started.items():
        log = logs[name]
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
