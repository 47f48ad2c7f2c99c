"""External-memory subsystem of the port: graph size independent of RAM
(paper §3).

The port of `repro.exmem`'s out-of-core build.  Each module maps onto a
paper construct, as in the reference:

  runs.py        §3.1's two I/O primitives: `external_sort` is `sort(X)`
                 (run formation plus a bounded-budget k-way merge of
                 memory-mapped `.npy` runs); `IOStats` is the cost model.
  tables.py      §2 Tables 2-3: `OocGraph` holds N_t and E_t as chunked,
                 checksummed on-disk tables in both sort orders, in the
                 reference's directory format (either package opens the
                 other's tables).
  build.py       §3.2 Algorithm 1 as a streamed pipeline
                 (`build_bisim_oocore`): merge join, external re-sort,
                 per-chunk fold on the card through the Hopper
                 `chunk_sig_fold` kernel, and ranking through a
                 `SpillableSigStore`, with per-level checkpoint/resume.
  aio.py         the async I/O pipeline (prefetch readers, streaming
                 writers, async run saves); it moves numpy chunks only.
  durability.py  manifests and atomically published JSON states.

The maintenance backend (`OocBackend`), the write-ahead log and the
streaming service arrive with later slices.
"""
from .aio import (AioConfig, AioStats, BoundedSaver, Pipeline,
                  PrefetchReader, ReadaheadArray, StreamingWriter)
from .build import OocBisimResult, build_bisim_oocore
from .durability import Manifest
from .runs import (IOStats, external_sort, lexsort_records, make_records,
                   merge_runs, rebuffer, sort_to_runs)
from .tables import ChunkedColumn, OocGraph

__all__ = [
    "OocBisimResult", "build_bisim_oocore", "IOStats", "external_sort",
    "lexsort_records", "make_records", "merge_runs", "rebuffer",
    "sort_to_runs", "ChunkedColumn", "OocGraph", "AioConfig", "AioStats",
    "BoundedSaver", "Pipeline", "PrefetchReader", "ReadaheadArray",
    "StreamingWriter", "Manifest",
]
