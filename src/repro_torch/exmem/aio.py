"""Async I/O pipeline: overlap disk traffic with the device fold.

The paper's out-of-core algorithms are I/O-*bounded* (`O(k·sort(|E_t|) +
k·scan(|N_t|) + sort(|N_t|))`), but bounded I/O issued *synchronously*
still serializes against the per-chunk device fold.  The paper overlaps
I/O with computation; this module is that knob as a first-class,
reusable subsystem rather than ad-hoc threading:

  PrefetchReader   a bounded one-chunk-ahead (configurable ``depth``)
                   background thread per stream.  Iterator-compatible, so
                   it drops into any existing ``for chunk in ...`` loop;
                   producer exceptions re-raise at the consumer;
                   ``close()`` (idempotent, also via context manager /
                   generator-style ``close``) stops and joins the thread.

  StreamingWriter  double-buffered append of a known-length ``.npy``
                   column (pid files, merged runs): chunks enqueue into a
                   bounded queue, a worker thread copies them into a
                   memmap at ``<path>.aio-tmp``; ``close()`` drains,
                   flushes, fsyncs, and atomically renames into place —
                   a partially written file is never visible under the
                   live name.  ``abort()`` discards the temp file.

  Pipeline         fans a reader through a transform into a writer (or
                   sink callable).  Backpressure is structural: the
                   reader's queue and the writer's queue are both
                   bounded, so a fast producer blocks instead of
                   buffering the table.

  ReadaheadArray   sequential block readahead over a memory-mapped run
                   for the k-way merge: serving block ``[s:e)`` schedules
                   ``[e:e+(e-s))`` on the shared executor, so the merge
                   loop's next input block is in flight while the current
                   one is being merged.

  AioConfig        the per-engine knob bundle (``io_threads``,
                   ``prefetch_depth``) plus the shared executor and an
                   `AioStats` overlap report (read-wait / write-wait
                   seconds, chunks moved).  ``io_threads=0`` disables
                   everything: every helper degrades to its synchronous
                   equivalent, producing byte-identical files.

Invariant: the pipeline never changes *what* is read or written, only
*when* — partitions are bit-identical and `IOStats` counters are exactly
equal with the pipeline on or off (tier-1 tested).  `IOStats` counting
may now happen from a reader thread concurrently with the consumer, so
`IOStats` guards its counters with a lock; `AioStats` (wall-clock
overlap, not I/O cost) stays separate precisely so the cost-model
counters stay deterministic.

Durability contract (see also `exmem.durability`): a published artifact
(``fsync=True``) is crash-durable, not merely atomic — the data blocks
are fsync'd *and the parent directory is fsync'd after the rename*, so
a committed file cannot vanish (or point at garbage) when the machine
dies right after `close()`/`atomic_save` returns.  Scratch files skip
both syncs.  Every write primitive passes through
`repro_torch.core.faults.fault_point`, so deterministic fault schedules can
kill, corrupt, or flake any write; `TransientIOError` is retried with
bounded backoff (`with_retries`) in `atomic_save` (and therefore
`BoundedSaver`) and in `StreamingWriter`'s append path, while readers
retry at the chunk-load level (`OocGraph._iter_table`) beneath any
`PrefetchReader` — a generator cannot be re-driven after it raises, so
the retry must live below it.  `StreamingWriter` keeps a running CRC-32
of every byte it publishes (``checksum`` after `close()`), which the
durable-artifact manifests record without re-reading the file.

The port's own copy of `repro.exmem.aio` (numpy only).
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import zlib
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
from numpy.lib.format import open_memmap

from ..core.faults import InjectedCrash, fault_point, with_retries
from ..obs import tracer as obs

_SENTINEL = object()
READER_THREAD_PREFIX = "exmem-aio-reader"
WRITER_THREAD_PREFIX = "exmem-aio-writer"
EXECUTOR_THREAD_PREFIX = "exmem-aio-pool"


def fsync_dir(path: str) -> None:
    """fsync a directory: makes a just-renamed entry durable.  Without
    this a crash after `os.replace` can lose the *name* even though the
    data blocks were fsync'd — the classic vanishing-commit bug."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish_torn(tmp: str, path: str) -> None:
    """Fault-injection helper: publish a half-truncated file under the
    live name and die — simulating a rename that reached the disk before
    the data blocks did (what checksum verification exists to catch)."""
    size = os.path.getsize(tmp)
    with open(tmp, "rb+") as f:
        f.truncate(max(size // 2, 1))
    os.replace(tmp, path)
    raise InjectedCrash(f"injected torn write published at {path}")


def atomic_save(path: str, arr: np.ndarray, *, fsync: bool = False) -> None:
    """``np.save`` via a temp file + atomic rename: the file is either
    absent or complete under ``path``, never partial.  ``fsync`` is for
    published artifacts that must survive a crash — it syncs the data
    *and the parent directory after the rename*, so the committed name
    itself is durable; scratch files (sort runs, spill runs — rebuilt
    from the tables anyway) skip both, since an fsync per run would
    serialize the whole pipeline on the disk.  Transient injected I/O
    errors are retried with bounded backoff."""
    def _save():
        verdict = fault_point("atomic_save", path)
        tmp = path + ".aio-tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if verdict == "torn":
            _publish_torn(tmp, path)
        os.replace(tmp, path)
        if fsync:
            fsync_dir(os.path.dirname(os.path.abspath(path)))

    with_retries(_save)


@dataclasses.dataclass
class AioStats:
    """Wall-clock overlap report (separate from `IOStats` by design: these
    are timings, not paper cost-model counters, and they legitimately
    differ between pipeline on/off)."""

    read_wait_s: float = 0.0     # consumer blocked waiting on a reader
    write_wait_s: float = 0.0    # producer blocked on a full writer queue
    chunks_prefetched: int = 0   # chunks handed over by reader threads
    chunks_written: int = 0      # chunks landed by writer threads
    bytes_written: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add_read_wait(self, dt: float) -> None:
        with self._lock:
            self.read_wait_s += dt
            self.chunks_prefetched += 1

    def add_write_wait(self, dt: float) -> None:
        with self._lock:
            self.write_wait_s += dt

    def add_written(self, nbytes: int) -> None:
        with self._lock:
            self.chunks_written += 1
            self.bytes_written += int(nbytes)

    def to_dict(self) -> dict:
        return {
            "read_wait_s": round(self.read_wait_s, 6),
            "write_wait_s": round(self.write_wait_s, 6),
            "chunks_prefetched": self.chunks_prefetched,
            "chunks_written": self.chunks_written,
            "bytes_written": self.bytes_written,
        }

    def as_dict(self) -> dict:
        """Uniform stats surface (same contract as `IOStats.as_dict` /
        `MaintenanceReport.as_dict`)."""
        return self.to_dict()

    def merge(self, other) -> "AioStats":
        """Fold another AioStats (or its `as_dict()`) into this one, in
        place: waits and chunk counts add."""
        d = other.as_dict() if hasattr(other, "as_dict") else dict(other)
        with self._lock:
            self.read_wait_s += float(d.get("read_wait_s", 0.0))
            self.write_wait_s += float(d.get("write_wait_s", 0.0))
            self.chunks_prefetched += int(d.get("chunks_prefetched", 0))
            self.chunks_written += int(d.get("chunks_written", 0))
            self.bytes_written += int(d.get("bytes_written", 0))
        return self


class _Raise:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchReader:
    """Iterator pulling up to ``depth`` chunks ahead on a daemon thread.

    Single-consumer.  Exhaustion, `close()`, or a producer exception all
    terminate the thread; `close()` is idempotent and safe mid-stream
    (the producer's blocked ``put`` observes the stop flag).  The wrapped
    source's own ``close`` (generators) runs in the producer thread, so
    upstream ``finally`` blocks — nested readers, open files — release.
    """

    def __init__(self, source: Iterable, depth: int = 1,
                 stats: Optional[AioStats] = None):
        self._src = iter(source)
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._stats = stats
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._pump, name=READER_THREAD_PREFIX, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self) -> None:
        try:
            try:
                while True:
                    # one span per produced chunk, on this reader thread's
                    # trace lane — upstream generator compute (table scans,
                    # sort merges) nests underneath it
                    with obs.span("aio.read_chunk"):
                        item = next(self._src, _SENTINEL)
                    if item is _SENTINEL:
                        self._put(_SENTINEL)
                        return
                    if not self._put(item):
                        return
            except BaseException as exc:  # re-raised at the consumer
                self._put(_Raise(exc))
        finally:
            close = getattr(self._src, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass

    def __iter__(self) -> "PrefetchReader":
        return self

    def __next__(self):
        if self._thread is None:
            raise StopIteration
        t0 = time.perf_counter()
        with obs.span("aio.wait_read"):
            item = self._q.get()
        if self._stats is not None:
            self._stats.add_read_wait(time.perf_counter() - t0)
        if item is _SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, _Raise):
            self.close()
            raise item.exc
        return item

    def close(self) -> None:
        thread, self._thread = self._thread, None
        if thread is None:
            return
        self._stop.set()
        # drain so a producer blocked on put() can observe the stop flag
        while thread.is_alive():
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
        thread.join()

    def __enter__(self) -> "PrefetchReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


class StreamingWriter:
    """Append-only writer of one known-length 1-D ``.npy`` file.

    ``write(arr)`` appends (the writer takes ownership: callers must not
    mutate the array afterwards).  With ``threaded=True`` chunks enqueue
    into a bounded queue and a worker copies them into the temp memmap —
    the double buffer.  ``close()`` drains, flushes, fsyncs (published
    artifacts only; ``fsync=False`` for scratch files) the data *and*
    the parent directory, and renames ``<path>.aio-tmp`` to ``path``;
    until then the live name is untouched.  A worker exception re-raises
    at the next ``write`` or at ``close``; ``abort()`` discards
    everything.  A running CRC-32 of every appended byte is kept
    (``checksum``, valid after a successful ``close()``), so manifest
    writers record the artifact's checksum without re-reading the file.
    """

    def __init__(self, path: str, dtype, length: int, *, depth: int = 2,
                 threaded: bool = True, stats: Optional[AioStats] = None,
                 fsync: bool = True):
        self.path = path
        self._tmp = path + ".aio-tmp"
        self._fsync = fsync
        self._mm = open_memmap(self._tmp, mode="w+", dtype=np.dtype(dtype),
                               shape=(int(length),))
        self._pos = 0
        self._crc = 0
        self._stats = stats
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self._q = queue.Queue(maxsize=max(int(depth), 1))
            self._thread = threading.Thread(
                target=self._pump, name=WRITER_THREAD_PREFIX, daemon=True)
            self._thread.start()

    @property
    def rows_written(self) -> int:
        return self._pos

    @property
    def checksum(self) -> int:
        """CRC-32 of the published data bytes (after a clean `close()`)."""
        return self._crc

    def _append(self, arr: np.ndarray) -> None:
        def _copy():
            fault_point("sw_write", self.path)
            n = arr.shape[0]
            self._mm[self._pos:self._pos + n] = arr
            self._pos += n

        with_retries(_copy)
        self._crc = zlib.crc32(
            np.ascontiguousarray(arr).tobytes(), self._crc) & 0xFFFFFFFF
        if self._stats is not None:
            self._stats.add_written(arr.nbytes)

    def _pump(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            if self._exc is None:
                try:
                    with obs.span("aio.write_chunk",
                                  file=os.path.basename(self.path)):
                        self._append(item)
                except BaseException as exc:
                    self._exc = exc  # keep draining so writers never block

    def write(self, arr) -> None:
        if self._closed:
            raise ValueError("write() after close()")
        if self._exc is not None:
            # re-raise but keep the failure sticky: a caller that catches
            # this and still calls close() must get the error again, not
            # a published partial file
            raise self._exc
        arr = np.asarray(arr)
        if self._thread is None:
            self._append(arr)
            return
        t0 = time.perf_counter()
        with obs.span("aio.wait_write"):
            self._q.put(arr)
        if self._stats is not None:
            self._stats.add_write_wait(time.perf_counter() - t0)

    def _take_exc(self) -> BaseException:
        exc, self._exc = self._exc, None
        return exc

    def _join(self) -> None:
        thread, self._thread = self._thread, None
        if thread is not None:
            self._q.put(_SENTINEL)
            thread.join()

    def close(self) -> None:
        """Drain, flush, fsync (data + parent dir), and atomically
        publish the file."""
        if self._closed:
            return
        self._closed = True
        self._join()
        mm, self._mm = self._mm, None
        if self._exc is None:
            mm.flush()
        del mm
        if self._exc is not None:
            try:
                os.remove(self._tmp)
            except OSError:
                pass
            raise self._take_exc()
        verdict = fault_point("sw_close", self.path)
        if self._fsync:
            with open(self._tmp, "rb+") as f:
                os.fsync(f.fileno())
        if verdict == "torn":
            _publish_torn(self._tmp, self.path)
        os.replace(self._tmp, self.path)
        if self._fsync:
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    def abort(self) -> None:
        """Stop the worker and discard the temp file (never publishes)."""
        if self._closed:
            return
        self._closed = True
        self._exc = None
        self._join()
        self._mm = None
        try:
            os.remove(self._tmp)
        except OSError:
            pass

    def __enter__(self) -> "StreamingWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    def __del__(self):
        try:
            if not self._closed:
                self.abort()
        except BaseException:
            pass


def _traced(fn: Callable, label: str) -> Callable:
    """Wrap an executor task in a span (only built while tracing is on,
    so the untraced submit path is unchanged)."""
    def run():
        with obs.span(label):
            return fn()
    return run


class _Done:
    """Synchronous stand-in for a Future (pipeline disabled)."""

    __slots__ = ("_exc",)

    def __init__(self, exc: Optional[BaseException] = None):
        self._exc = exc

    def result(self):
        if self._exc is not None:
            raise self._exc
        return None


class ReadaheadArray:
    """Sequential windowed readahead over a (memmapped) run for the k-way
    merge core.  The core reads each source in small strictly sequential
    blocks (``budget_rows // fan_in``); issuing one executor round-trip
    per block would swamp the win, so the readahead operates on *windows*
    of ~``window_bytes``: serving a block from the current window is a
    plain slice, and crossing into the next window picks up the read that
    was scheduled when the previous one was adopted.  Non-sequential or
    strided access falls back to a direct read.  ``field(name)`` exposes
    one structured field as a parallel column over the same shared window
    (one disk read serves the key views and the record payload
    together)."""

    # windows span several core blocks (fewer executor round-trips) but
    # stay a small multiple of the caller's own block size, so the merge
    # budget is overshot by a constant factor, not by a fixed byte count
    BLOCKS_PER_WINDOW = 4

    def __init__(self, arr: np.ndarray, aio: "AioConfig",
                 window_bytes: int = 1 << 20):
        self._arr = arr
        self._aio = aio
        itemsize = max(int(arr.dtype.itemsize), 1)
        self._win_cap = max(int(window_bytes) // itemsize, 1)
        self._win_rows: Optional[int] = None   # fixed by the first block
        self._lo = self._hi = 0                # current buffered window
        self._buf: Optional[np.ndarray] = None
        self._next = None                      # (lo, hi, future) in flight

    @property
    def shape(self) -> tuple:
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def field(self, name: str) -> "_ReadaheadField":
        return _ReadaheadField(self, name)

    def __getitem__(self, sl):
        if isinstance(sl, str):
            return self.field(sl)
        start, stop, step = sl.indices(self._arr.shape[0])
        if step != 1:
            return np.array(self._arr[sl])
        return self._block(start, stop)

    def _schedule(self, lo: int) -> None:
        n = self._arr.shape[0]
        if lo >= n:
            self._next = None
            return
        hi = min(lo + self._win_rows, n)
        arr = self._arr
        self._next = (lo, hi, self._aio.submit(
            lambda a=arr, s=lo, e=hi: np.array(a[s:e]),
            label="aio.readahead"))

    def _block(self, start: int, stop: int) -> np.ndarray:
        if self._win_rows is None:
            # a whole multiple of the caller's block size (>= 1 block,
            # even past the byte cap): sequential block reads then cross
            # window boundaries exactly, so every scheduled window is
            # adopted instead of discarded as misaligned
            block = max(stop - start, 1)
            self._win_rows = block * max(
                1, min(self.BLOCKS_PER_WINDOW, self._win_cap // block))
        if self._buf is None or start < self._lo or stop > self._hi:
            adopted = False
            if self._next is not None:
                nlo, nhi, fut = self._next
                self._next = None
                if nlo <= start and stop <= nhi:
                    self._buf = fut.result()
                    self._lo, self._hi = nlo, nhi
                    adopted = True
                    if self._aio.stats is not None:
                        self._aio.stats.add_read_wait(0.0)
                else:
                    fut.result()  # drop a stale readahead
            if not adopted:
                lo = start
                hi = min(max(stop, lo + self._win_rows),
                         self._arr.shape[0])
                self._buf = np.array(self._arr[lo:hi])
                self._lo, self._hi = lo, hi
            self._schedule(self._hi)
        return self._buf[start - self._lo:stop - self._lo]


class _ReadaheadField:
    """One structured field of a `ReadaheadArray`, as a parallel column."""

    __slots__ = ("_parent", "_name")

    def __init__(self, parent: ReadaheadArray, name: str):
        self._parent = parent
        self._name = name

    @property
    def shape(self) -> tuple:
        return self._parent.shape

    def __getitem__(self, sl) -> np.ndarray:
        return self._parent[sl][self._name]


@dataclasses.dataclass
class AioConfig:
    """Knob bundle for one engine instance: thread count, queue depth,
    the shared executor for block readahead / async run saves, and the
    overlap stats every reader/writer charges.  ``io_threads=0`` turns
    the whole pipeline off (synchronous fallbacks, same bytes)."""

    io_threads: int = 1
    prefetch_depth: int = 2
    stats: AioStats = dataclasses.field(default_factory=AioStats)

    def __post_init__(self):
        self._executor = None
        self._closed = False
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.io_threads > 0

    # ------------------------------------------------------------- readers
    def prefetch(self, source: Iterable) -> Iterator:
        """Wrap a chunk iterator in a `PrefetchReader` (or return it
        unchanged when the pipeline is off)."""
        if not self.enabled:
            return iter(source)
        return PrefetchReader(source, depth=self.prefetch_depth,
                              stats=self.stats)

    def readahead(self, arr: np.ndarray):
        """Block-readahead view of a run for the k-way merge."""
        if not self.enabled:
            return arr
        return ReadaheadArray(arr, self)

    # ------------------------------------------------------------- writers
    def writer(self, path: str, dtype, length: int, *,
               fsync: bool = True) -> StreamingWriter:
        return StreamingWriter(path, dtype, length,
                               depth=max(self.prefetch_depth, 1),
                               threaded=self.enabled, stats=self.stats,
                               fsync=fsync)

    def submit(self, fn: Callable, label: str = "aio.task"):
        """Run ``fn`` on the shared executor; returns a Future-alike.
        Runs synchronously when the pipeline is off — or after
        ``close()``, so late users of a retired config (kept stores
        resolving new signatures after their build) degrade gracefully
        instead of resurrecting an executor nobody will shut down."""
        if obs.current_tracer() is not None:
            fn = _traced(fn, label)  # pool-lane span per task
        if self.enabled:
            with self._lock:
                if self._executor is None and not self._closed:
                    from concurrent.futures import ThreadPoolExecutor
                    self._executor = ThreadPoolExecutor(
                        max_workers=self.io_threads,
                        thread_name_prefix=EXECUTOR_THREAD_PREFIX)
                if self._executor is not None:
                    return self._executor.submit(fn)
        try:
            fn()
            return _Done()
        except BaseException as exc:
            return _Done(exc)

    def save_async(self, path: str, arr: np.ndarray, *,
                   fsync: bool = False):
        """Atomic-rename `np.save` on the executor (sync when disabled).
        Defaults to no fsync: the async saves are scratch runs/chunks."""
        return self.submit(lambda: atomic_save(path, arr, fsync=fsync),
                           label="aio.save")

    def saver(self) -> "BoundedSaver":
        """A `BoundedSaver` over this config (see there)."""
        return BoundedSaver(self)

    @property
    def max_pending(self) -> int:
        """Bound on outstanding async saves before the producer waits."""
        return max(self.io_threads, 1) + max(self.prefetch_depth, 1)

    def close(self) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
            self._closed = True
        if executor is not None:
            executor.shutdown(wait=True)


class BoundedSaver:
    """Issue atomic file saves with a bounded number in flight.

    The one idiom every many-files producer needs (run formation, table
    rewrites): `save()` hands the array to the config's executor and, past
    ``aio.max_pending`` outstanding saves, blocks on the oldest — so a
    fast producer can't queue an unbounded pile of chunks in RAM.  With a
    disabled (or absent) config every save runs synchronously.  `drain()`
    (call it before using the files, and in a ``finally`` so background
    writes can't race a cleanup rmtree) waits for everything in flight.
    """

    def __init__(self, aio: "Optional[AioConfig]"):
        self._aio = aio
        self._pending: list = []

    def save(self, path: str, arr: np.ndarray, *, fsync: bool = False
             ) -> None:
        if self._aio is not None and self._aio.enabled:
            self._pending.append(
                self._aio.save_async(path, arr, fsync=fsync))
            while len(self._pending) > self._aio.max_pending:
                self._pending.pop(0).result()
        else:
            atomic_save(path, arr, fsync=fsync)

    def drain(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()


class Pipeline:
    """Reader -> transform -> writer with structural backpressure.

    ``source`` chunks are prefetched (per ``aio``), passed through
    ``transform`` (main thread, so `IOStats` accounting inside it stays
    ordered), and appended to ``writer`` (a `StreamingWriter`) or handed
    to ``sink`` (any callable).  Both hand-off queues are bounded, so no
    stage can run away from the others.  Returns the chunk count."""

    def __init__(self, source: Iterable, *, transform: Optional[Callable] = None,
                 writer: Optional[StreamingWriter] = None,
                 sink: Optional[Callable] = None,
                 aio: Optional[AioConfig] = None):
        if (writer is None) == (sink is None):
            raise ValueError("exactly one of writer/sink is required")
        self._source = source
        self._transform = transform
        self._emit = writer.write if writer is not None else sink
        self._aio = aio

    def run(self) -> int:
        it = (self._aio.prefetch(self._source) if self._aio is not None
              else iter(self._source))
        chunks = 0
        try:
            for chunk in it:
                if self._transform is not None:
                    chunk = self._transform(chunk)
                if chunk is None:
                    continue
                self._emit(chunk)
                chunks += 1
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        return chunks


def live_aio_threads() -> list:
    """Names of live pipeline threads (tests: leak detection)."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith(READER_THREAD_PREFIX)
            or t.name.startswith(WRITER_THREAD_PREFIX)]
