"""Durable-artifact layer of the out-of-core build: manifests and
atomically published JSON states.

Every multi-file artifact the out-of-core engine must be able to trust
after a crash — `OocGraph` table directories, build checkpoints — is
described by a **manifest**: a versioned JSON file listing every member
file with its row count and CRC-32 (of the array data bytes; see
`repro_torch.core.integrity`).  The manifest is written last, atomically,
with file-and-directory fsync, so *manifest present and verifying* is the
commit point of the whole artifact: a crash at any earlier instant leaves
either the previous manifest (previous artifact intact) or no manifest
(artifact not yet committed), never a torn state that verifies.

  Manifest        relpath -> (rows, crc32) map with `add_array` /
                  `add_file` recorders (checksums computed while the
                  bytes are still in RAM or streaming past — no second
                  read), `write` (atomic + fsync'd) and `verify`
                  (raises `ChecksumError`, never returns wrong data).

  atomic_write_json / read_json
                  the same publish discipline for small JSON states
                  (build checkpoints).

The port's own copy of the build's part of `repro.exmem.durability`
(numpy only); the maintenance write-ahead log arrives with the streaming
slice.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from ..core.faults import fault_point, with_retries
from ..core.integrity import ChecksumError, crc32_array, verify_npy

from . import aio as aio_mod

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


def atomic_write_json(path: str, obj: dict, *, fsync: bool = True) -> None:
    """Publish a JSON file atomically (temp + rename + file/dir fsync)."""
    def _write():
        fault_point("json_write", path)
        tmp = path + ".aio-tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=True)
            f.write("\n")
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            aio_mod.fsync_dir(os.path.dirname(os.path.abspath(path)))

    with_retries(_write)


def read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as exc:
        raise ChecksumError(f"unreadable JSON artifact {path!r}: {exc}") \
            from exc


class Manifest:
    """Versioned (relpath -> rows, crc32) map over one artifact dir."""

    def __init__(self, files: Optional[dict] = None,
                 meta: Optional[dict] = None):
        self.files: dict = dict(files or {})   # relpath -> [rows, crc32]
        self.meta: dict = dict(meta or {})     # free-form artifact metadata

    # ------------------------------------------------------------ recording
    def add_array(self, relpath: str, arr: np.ndarray) -> None:
        """Record an array about to be (or just) saved as ``relpath``."""
        self.files[relpath] = [int(arr.shape[0]), crc32_array(arr)]

    def add_checksum(self, relpath: str, rows: int, crc: int) -> None:
        self.files[relpath] = [int(rows), int(crc)]

    def add_file(self, root: str, relpath: str) -> None:
        """Record an existing ``.npy`` file by reading it once."""
        arr = np.load(os.path.join(root, relpath), mmap_mode="r")
        self.files[relpath] = [int(arr.shape[0]),
                               crc32_array(np.asarray(arr))]

    def drop_prefix(self, prefix: str) -> None:
        """Forget every entry under ``prefix`` (a table being rewritten)."""
        for rel in [r for r in self.files if r.startswith(prefix)]:
            del self.files[rel]

    # ------------------------------------------------------------------ IO
    def write(self, root: str, name: str = MANIFEST_NAME) -> None:
        atomic_write_json(os.path.join(root, name), {
            "version": MANIFEST_VERSION,
            "meta": self.meta,
            "files": self.files,
        })

    @classmethod
    def load(cls, root: str, name: str = MANIFEST_NAME) -> "Manifest":
        obj = read_json(os.path.join(root, name))
        if obj.get("version") != MANIFEST_VERSION:
            raise ChecksumError(
                f"unsupported manifest version in {root!r}: "
                f"{obj.get('version')!r}")
        return cls(files=obj.get("files", {}), meta=obj.get("meta", {}))

    @classmethod
    def load_if_present(cls, root: str,
                        name: str = MANIFEST_NAME) -> "Optional[Manifest]":
        if not os.path.exists(os.path.join(root, name)):
            return None
        return cls.load(root, name)

    # -------------------------------------------------------- verification
    def verify(self, root: str, relpaths=None, *, stats=None) -> None:
        """Full checksum verification of the listed files (default: all).
        Raises `ChecksumError` naming the first corrupt/truncated/missing
        file; charges ``stats.count_scan`` for the verification read."""
        for rel in (relpaths if relpaths is not None
                    else sorted(self.files)):
            rows, crc = self.files[rel]
            arr = verify_npy(os.path.join(root, rel), crc,
                             expected_rows=rows)
            if stats is not None:
                stats.count_scan(arr.shape[0], arr.nbytes)

    def verify_copy(self, src_root: str, dst_root: str, *,
                    stats=None) -> None:
        """Copy every listed file ``src_root`` -> ``dst_root``, verifying
        checksums from the bytes as they stream past (one read, not
        two).  The restore path uses this so adopting a snapshot is also
        its integrity check."""
        for rel in sorted(self.files):
            rows, crc = self.files[rel]
            src = os.path.join(src_root, rel)
            arr = verify_npy(src, crc, expected_rows=rows)
            dst = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            aio_mod.atomic_save(dst, arr)
            if stats is not None:
                stats.count_scan(arr.shape[0], arr.nbytes)


def commit_dir_swap(live: str, tmp: str) -> None:
    """Atomically swap a fully-written ``tmp`` directory into the ``live``
    name (old dir renamed aside until the new one holds the name), with
    the parent directory fsync'd so the swap survives a crash."""
    bak = live + ".bak"
    shutil.rmtree(bak, ignore_errors=True)
    if os.path.exists(live):
        os.replace(live, bak)
    os.replace(tmp, live)
    aio_mod.fsync_dir(os.path.dirname(os.path.abspath(live)))
    shutil.rmtree(bak, ignore_errors=True)
