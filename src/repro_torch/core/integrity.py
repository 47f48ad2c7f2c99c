"""Artifact integrity: checksums for every durable out-of-core file.

The external-memory engine's durable artifacts — `OocGraph` chunk files,
per-level pid files, `SpillableSigStore` spill runs, WAL records — are
all numpy arrays on disk.  A torn write or a flipped byte in any of them
would otherwise surface as a *silently wrong partition*; this module
makes corruption a loud `ChecksumError` at open instead.

Checksums are CRC-32 (`zlib.crc32`, the container ships no xxhash) over
the **array data bytes**, not the file bytes: the writers already hold
the array in memory when they persist it, so recording a checksum costs
zero extra I/O, and verification is one sequential `np.load` + crc pass.
A corrupted ``.npy`` header fails `np.load` itself; both failure shapes
are normalized to `ChecksumError` by `verify_npy`.

This module lives in `repro_torch.core` (not `repro_torch.exmem`) so the store layer
(`core.sig_store`) can verify its spill runs without importing the exmem
package — the dependency arrow stays exmem -> core.

The port's own copy of `repro.core.integrity` (numpy only).
"""
from __future__ import annotations

import zlib

import numpy as np


class ChecksumError(IOError):
    """A durable artifact failed integrity verification at open."""


def crc32_array(arr: np.ndarray) -> int:
    """CRC-32 of an array's data bytes (C-contiguous view)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_update(crc: int, arr: np.ndarray) -> int:
    """Fold another array's data bytes into a running CRC-32 (for writers
    that stream an artifact out in blocks)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc) & 0xFFFFFFFF


def verify_npy(path: str, expected_crc: int,
               expected_rows: "int | None" = None) -> np.ndarray:
    """Load ``path`` and verify it against the recorded checksum.

    Raises `ChecksumError` on a missing/truncated/unparsable file, a row
    count mismatch, or a data checksum mismatch — never returns silently
    wrong data.  Returns the loaded array so callers verifying at open
    don't pay a second read.
    """
    try:
        arr = np.load(path)
    except (OSError, ValueError, EOFError) as exc:
        raise ChecksumError(
            f"unreadable artifact {path!r}: {exc}") from exc
    if expected_rows is not None and arr.shape[0] != expected_rows:
        raise ChecksumError(
            f"truncated artifact {path!r}: {arr.shape[0]} rows, "
            f"manifest says {expected_rows}")
    got = crc32_array(arr)
    if got != int(expected_crc):
        raise ChecksumError(
            f"checksum mismatch in {path!r}: crc32 {got:#010x} != "
            f"recorded {int(expected_crc):#010x}")
    return arr
