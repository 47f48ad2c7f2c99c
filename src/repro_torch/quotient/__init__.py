"""Quotient serving: a structural query engine over the k-bisimulation
partition — the subsystem that makes the partition pay rent.

The port of `repro.quotient`: the same artifact (either package loads
the other's), the same query algebra and answers, the same epoch
contract.  The engine's waves run on the card (`engine.py`); the rest is
the reference's host numpy.

The paper's partition is a *structural index*: two nodes sharing pId_j
are indistinguishable within radius j, so a label-path query of length
m <= j has the same answer for every member of a level-j block.  This
package materializes that index as per-level quotient graphs, serves
structural queries on them with a fixed-slot batched device evaluator
(the `serve/engine.py` wave idiom), and keeps the artifact queryable
while `BisimMaintainer` streams updates underneath it.

Quotient graph Q_j
==================
For each level j in 1..k, Q_j has one node per level-j block (the pid
itself is the node id) and the deduplicated edge set

    (pId_j(s), eLabel, pId_{j-1}(t))   for every (s, eLabel, t) in E.

The target is ranked at level j-1 *by construction*: sig_j(s) is
defined over the targets' pId_{j-1}, so every member of a level-j
block carries exactly the same (eLabel, pId_{j-1}) out-set.  That
makes Q_j edges *uniform* (not merely existential), which is what
makes query answers exact rather than over-approximate.  Each Q_j is
persisted as a `repro_torch.exmem.OocGraph` directory (chunked tables in
both sort orders, CRC-32 `Manifest`, torn-file rejection at load);
`src` ids live in [0, counts[j]) and `dst` ids are raw level-(j-1)
pids in [0, counts[j-1]).

Query algebra
=============
Three query shapes (`quotient.queries`):

* `LabelPath(labels, level=j)` — every node with an outgoing path
  whose edge labels spell `labels`.  Answered by m = len(labels)
  backward hops down the level ladder Q_j, Q_{j-1}, ..., Q_{j-m+1}:
  S_m = all blocks at level j-m; S_t = {P : (P, labels[t], Q) in
  Q_{j-t}, Q in S_{t+1}}.  Because each hop's edge relation is
  uniform, S_0 expanded to node ids equals the brute-force answer on
  the original graph whenever m <= j (the classic k-bisimulation
  exactness guarantee; the engine enforces m <= level <= k).
* `ReachTemplate(src_label, labels, tgt_label, level)` — the same
  path, with optional node-label constraints on both endpoints
  (applied to the per-block label columns, which are uniform within a
  block since every level refines pId_0).
* `PointLookup(node, level)` — pId_level(node) and its block size,
  answered by `searchsorted` over the extent runs (no pid column is
  ever materialized).

`queries.eval_ref` is the numpy reference evaluator (the engine's
bit-parity oracle) and `queries.eval_brute` evaluates directly on the
original `Graph` (the ground truth the differential tests compare
both against).

Extent-run format
=================
Per level j the member set of every block is stored as *sorted
node-id runs*: the pId_j column run-length encoded into two parallel
arrays ``start`` (int64, strictly increasing, tiling [0, N)) and
``pid`` (int64) — run r covers node ids [start[r], start[r+1]).
`pid_of` is one `searchsorted`; block expansion concatenates the
block's runs (grouped by a lazily built (pid, start) index) into
ascending node ids.  Updates splice runs in place
(`ExtentRuns.splice`): only the runs overlapping changed node-id
intervals are rewritten, never the whole column.

Epoch / staleness contract
==========================
`QuotientService` wires a `BisimMaintainer` to a served index with a
monotone epoch counter:

* Every update batch (add_edges / delete_edges / delete_node /
  add_nodes / compact / change_k) advances `service.epoch` by exactly
  one once the quotient absorbs it.
* Absorption is an *incremental patch*: the maintainer records which
  nodes changed pid per level, and only those blocks' quotient rows
  are merge-inserted (the `core/kway.py` emit-boundary merge, the
  same path as `OocGraph.insert_edges`) — full rematerialization
  happens only on rebuild/compact/change_k, where ids or levels
  themselves move.  Patched rows are insert-only: a block that loses
  every member keeps its stale rows, but correct rows can never
  reference an empty block (a member's signature names only live
  target pids), so stale rows are unreachable from live answers and
  expand to zero node ids.
* Queries never observe a half-applied patch: the engine serves the
  previous snapshot's device arrays until the patch commits, then the
  swap and the epoch increment happen together.  `engine.epoch` names
  the snapshot a batch of answers was computed against, so staleness
  is bounded and observable: answers at epoch e reflect every update
  with sequence number <= e and nothing newer.
"""
from .materialize import (ExtentRuns, QuotientIndex, QuotientLevel,
                          materialize_quotient)
from .queries import (LabelPath, PointAnswer, PointLookup, ReachTemplate,
                      eval_brute, eval_ref, expand_blocks, normalize_query,
                      point_lookup)
from .engine import QuotientEngine
from .service import QuotientService

__all__ = [
    "ExtentRuns", "QuotientIndex", "QuotientLevel", "materialize_quotient",
    "LabelPath", "ReachTemplate", "PointLookup", "PointAnswer",
    "eval_brute", "eval_ref", "expand_blocks", "normalize_query",
    "point_lookup", "QuotientEngine", "QuotientService",
]
