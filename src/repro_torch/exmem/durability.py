"""Durable-artifact layer: manifests, the maintenance WAL, and snapshots.

Every multi-file artifact the out-of-core engine must be able to trust
after a crash — `OocGraph` table directories, build checkpoints,
maintenance snapshots — is described by a **manifest**: a versioned JSON
file listing every member file with its row count and CRC-32 (of the
array data bytes; see `repro_torch.core.integrity`).  The manifest is
written last, atomically, with file-and-directory fsync, so *manifest
present and verifying* is the commit point of the whole artifact: a crash
at any earlier instant leaves either the previous manifest (previous
artifact intact) or no manifest (artifact not yet committed), never a
torn state that verifies.

  Manifest        relpath -> (rows, crc32) map with `add_array` /
                  `add_file` recorders (checksums computed while the
                  bytes are still in RAM or streaming past — no second
                  read), `write` (atomic + fsync'd) and `verify`
                  (raises `ChecksumError`, never returns wrong data).

  atomic_write_json / read_json
                  the same publish discipline for small JSON states
                  (build checkpoints, snapshot state files).

  WriteAheadLog   the group-commit maintenance WAL (`OocBackend`):
                  `append` serializes one logical update batch
                  (op name + numpy arrays) into ``rec_<lsn>.npy`` via a
                  `StreamingWriter`, `commit` makes a batch of appended
                  records durable in one fsync round (record files,
                  then a commit line ``<lsn> <crc> <nbytes>`` in
                  ``commits.log``, then the log fsync — commit order ==
                  lsn order).  `replay(after_lsn)` yields committed
                  records in lsn order, verifying each payload's CRC
                  (corruption raises `ChecksumError`); uncommitted tail
                  records are ignored, exactly the group-commit loss
                  window.  `truncate(upto_lsn)` prunes records a
                  snapshot has absorbed.

Recovery composes the two: a snapshot directory (committed by its
manifest) is the redo base, and `replay` re-applies every committed
update with lsn greater than the snapshot's — the live, possibly
half-mutated working state is *discarded*, which is what makes redo of
non-idempotent table rewrites safe.

The port's own copy of `repro.exmem.durability` (numpy only: a WAL holds
no tensor).  The byte layout — ``rec_<lsn:08d>.npy`` records (an
in-memory ``.npz`` as a uint8 column), the ``<lsn> <crc32> <nbytes>``
lines of ``commits.log`` and ``floor.json`` — is the reference's, so
either package replays the other's log and restores its snapshots.
"""
from __future__ import annotations

import io as _io
import json
import os
import shutil
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.faults import fault_point, with_retries
from ..core.integrity import ChecksumError, crc32_array, verify_npy
from ..obs import tracer as obs

from . import aio as aio_mod

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
WAL_VERSION = 1


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


# --------------------------------------------------------------------- WAL
def _encode_record(op: str, arrays: dict) -> np.ndarray:
    """Serialize one logical update (op name + named numpy arrays) into a
    flat uint8 column (an in-memory ``.npz``)."""
    buf = _io.BytesIO()
    np.savez(buf, __op__=np.frombuffer(op.encode("utf-8"), np.uint8),
             **{k: np.asarray(v) for k, v in arrays.items()})
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def _decode_record(payload: np.ndarray) -> Tuple[str, dict]:
    with np.load(_io.BytesIO(payload.tobytes())) as z:
        op = bytes(z["__op__"]).decode("utf-8")
        arrays = {k: z[k] for k in z.files if k != "__op__"}
    return op, arrays


class WriteAheadLog:
    """Group-commit redo log of logical maintenance updates.

    Layout under ``root``: ``rec_<lsn:08d>.npy`` (uint8 payload per
    batch) plus ``commits.log`` (one fsync'd line per durable record:
    ``<lsn> <crc32> <nbytes>``).  A record is durable iff its commit
    line is; `replay` honors exactly the committed prefix and verifies
    every payload checksum.  ``group`` batches commit fsyncs: appended
    records become durable at the next `commit()` — automatic every
    ``group`` appends, forced by `flush()`/snapshot/close — so a crash
    loses at most the last ``group - 1`` acknowledged-but-uncommitted
    updates (bounded, documented staleness; ``group=1`` commits every
    batch).

    ``async_commits=True`` moves the per-group fsync round onto the
    shared aio executor: `append` still seals the group, but the fsyncs
    happen in the background while the caller keeps ingesting.  Rounds
    are chained (each waits on its predecessor before publishing commit
    lines) so commit order stays lsn order; `drain()`/`commit()`/
    `close()` wait for every in-flight round — and re-raise its error —
    before returning, so a clean close never leaves a round running on
    the executor or a partially published group.
    """

    FLOOR_NAME = "floor.json"

    def __init__(self, root: str, *, group: int = 1,
                 aio: "Optional[aio_mod.AioConfig]" = None,
                 start_lsn: int = 0, async_commits: bool = False):
        if group < 1:
            raise ValueError("group must be >= 1")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.group = int(group)
        self.aio = aio
        self.async_commits = bool(async_commits)
        self._pending: list = []   # [(lsn, path, crc, nbytes)] not committed
        self._commit_lock = threading.Lock()
        self._inflight = None      # future of the newest async commit round
        # start_lsn floors the numbering: a snapshot that absorbed (and
        # truncated) the whole log leaves commits.log empty, but new
        # records must still number past the snapshot's wal_lsn or the
        # next replay's `lsn > after_lsn` filter would skip them.  The
        # floor file (written durably by `truncate` *before* the log
        # shrinks) covers reopens that don't know the snapshot's wal_lsn.
        self.committed_lsn = max(int(start_lsn), self._read_floor())
        for lsn, _, _ in self._committed_lines():
            self.committed_lsn = max(self.committed_lsn, lsn)
        self.last_lsn = self.committed_lsn  # highest lsn ever appended

    def _read_floor(self) -> int:
        path = os.path.join(self.root, self.FLOOR_NAME)
        if not os.path.exists(path):
            return 0
        try:
            return int(read_json(path).get("floor", 0))
        except ChecksumError:
            # the floor only supplements start_lsn; an unreadable file
            # must not block recovery (atomic_write_json makes a torn
            # floor near-impossible anyway)
            return 0

    # ------------------------------------------------------------ appending
    def _rec_path(self, lsn: int) -> str:
        return os.path.join(self.root, f"rec_{lsn:08d}.npy")

    def append(self, op: str, arrays: dict) -> int:
        """Append one logical update batch; returns its lsn.  The record
        file is fully written here (no fsync yet); durability arrives at
        the next `commit`."""
        lsn = self.last_lsn + 1
        with obs.span("wal.append", op=op, lsn=lsn):
            payload = _encode_record(op, arrays)
            path = self._rec_path(lsn)
            writer = aio_mod.StreamingWriter(path, np.uint8,
                                             payload.shape[0],
                                             threaded=False, fsync=False)
            try:
                fault_point("wal_append", path)
                writer.write(payload)
            except BaseException:
                writer.abort()
                raise
            writer.close()
        self.last_lsn = lsn
        self._pending.append((lsn, path, writer.checksum,
                              int(payload.shape[0])))
        if len(self._pending) >= self.group:
            if self.async_commits:
                self.commit_async()
            else:
                self.commit()
        return lsn

    def _commit_round(self, pending) -> None:
        """One durable fsync round over ``pending`` records: fsync the
        record files, append their commit lines in lsn order, fsync the
        commit log and the WAL directory."""
        with self._commit_lock:
            with obs.span("wal.commit", records=len(pending),
                          lsn=pending[-1][0]):
                for _, path, _, _ in pending:
                    fault_point("wal_commit", path)
                    with open(path, "rb") as f:
                        os.fsync(f.fileno())
                log = os.path.join(self.root, "commits.log")
                with open(log, "a") as f:
                    for lsn, _, crc, nbytes in pending:
                        f.write(f"{lsn} {crc} {nbytes}\n")
                    f.flush()
                    os.fsync(f.fileno())
                aio_mod.fsync_dir(self.root)
            self.committed_lsn = pending[-1][0]

    def commit_async(self) -> None:
        """Seal the pending group and make it durable on the aio
        executor.  Rounds chain on their predecessor so commit lines hit
        ``commits.log`` in lsn order even with a multi-thread pool; with
        no executor configured this degrades to a synchronous commit."""
        if not self._pending:
            return
        if self.aio is None:
            self.commit()
            return
        pending, self._pending = self._pending, []
        prev = self._inflight

        def _round():
            if prev is not None:
                prev.result()
            self._commit_round(pending)

        self._inflight = self.aio.submit(_round, label="wal.commit.async")

    def drain(self) -> None:
        """Wait for every in-flight async commit round; re-raise its
        error.  After `drain` returns, everything previously sealed by
        `commit_async` is durable (or the failure has surfaced here)."""
        fut, self._inflight = self._inflight, None
        if fut is not None:
            fut.result()

    def commit(self) -> None:
        """Make every pending record durable: drain in-flight async
        rounds, then run one synchronous fsync round over the pending
        group."""
        self.drain()
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._commit_round(pending)

    flush = commit

    # -------------------------------------------------------------- replay
    def _committed_lines(self) -> Iterator[Tuple[int, int, int]]:
        log = os.path.join(self.root, "commits.log")
        if not os.path.exists(log):
            return
        with open(log) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 3:
                    # a torn final line: everything before it committed
                    # in order, so stop at the first unparsable line
                    return
                yield int(parts[0]), int(parts[1]), int(parts[2])

    def replay(self, after_lsn: int = 0) -> Iterator[Tuple[int, str, dict]]:
        """Yield (lsn, op, arrays) for every *committed* record with
        ``lsn > after_lsn``, in lsn order, verifying payload checksums.
        A committed record that is missing or corrupt raises
        `ChecksumError` — recovery never silently skips a durable
        update."""
        for lsn, crc, nbytes in self._committed_lines():
            if lsn <= after_lsn:
                continue
            with obs.span("wal.replay", lsn=lsn, bytes=nbytes):
                payload = verify_npy(self._rec_path(lsn), crc,
                                     expected_rows=nbytes)
                op, arrays = _decode_record(payload)
            yield lsn, op, arrays

    # ------------------------------------------------------------ truncate
    def truncate(self, upto_lsn: int) -> None:
        """Drop records with ``lsn <= upto_lsn`` (absorbed by a
        snapshot).  The lsn floor is published durably *first*, then the
        commit log is rewritten atomically; record files are removed
        only after the new log is durable, so a crash at any point
        mid-truncate leaves either the full old log (floor already
        durable) or the new log plus harmless orphan record files
        (replay is driven by the log) — and a reopen can never reissue
        an lsn the truncated log no longer witnesses."""
        self.drain()
        floor_path = os.path.join(self.root, self.FLOOR_NAME)
        fault_point("wal_truncate", floor_path)
        atomic_write_json(floor_path,
                          {"floor": max(int(upto_lsn), self._read_floor())})
        keep = [(lsn, crc, nb) for lsn, crc, nb in self._committed_lines()
                if lsn > upto_lsn]
        log = os.path.join(self.root, "commits.log")
        tmp = log + ".aio-tmp"
        with open(tmp, "w") as f:
            for lsn, crc, nb in keep:
                f.write(f"{lsn} {crc} {nb}\n")
            f.flush()
            os.fsync(f.fileno())
        fault_point("wal_truncate", log)
        os.replace(tmp, log)
        aio_mod.fsync_dir(self.root)
        fault_point("wal_truncate", self.root)
        for name in os.listdir(self.root):
            if name.startswith("rec_") and name.endswith(".npy"):
                lsn = int(name[4:-4])
                if lsn <= upto_lsn:
                    os.remove(os.path.join(self.root, name))

    def close(self) -> None:
        """Flush + drain: after `close` returns no commit round is
        running on the executor and every appended record either has a
        durable commit line or was never acknowledged as committed."""
        self.commit()
