"""The paper's primary contribution, ported: Algorithm 1 (the in-memory
k-bisimulation build) on PyTorch, with its signature stores (the
spillable sorted file S of the out-of-core build included), the exact
oracle, the state hand-over to and from the JAX package, the integrity
and fault-injection layer of the out-of-core engine, and the maintenance
of a built partition under updates (Algorithms 2-4, in memory, with
device propagation), and the distributed build over a `torch.distributed`
process group (the reference's device mesh)."""
from .partition import (BisimResult, IterationStats, bisim_step, build_bisim,
                        partition_blocks, refines, same_partition)
from .distributed import ShardedGraph, build_bisim_distributed, shard_graph
from .faults import (FaultPlan, InjectedCrash, TransientIOError,
                     install_fault_plan, with_retries)
from .integrity import ChecksumError, crc32_array, verify_npy
from .maintenance import (BisimMaintainer, InMemoryBackend,
                          MaintenanceBackend, MaintenanceReport)
from .oracle import is_k_bisimilar, oracle_pids
from .sig_store import (SigStore, SpillableSigStore, fuse_key, label_key,
                        split_key)
from .state import graph_from_numpy, result_from_numpy, result_to_numpy
from . import hashes_np, signatures

__all__ = [
    "BisimResult", "IterationStats", "bisim_step", "build_bisim",
    "partition_blocks", "refines", "same_partition", "ShardedGraph",
    "build_bisim_distributed", "shard_graph", "is_k_bisimilar",
    "oracle_pids", "SigStore", "SpillableSigStore", "fuse_key",
    "label_key", "split_key", "graph_from_numpy", "result_from_numpy",
    "result_to_numpy", "hashes_np", "signatures", "FaultPlan",
    "InjectedCrash", "TransientIOError", "install_fault_plan",
    "with_retries", "ChecksumError", "crc32_array", "verify_npy",
    "BisimMaintainer", "InMemoryBackend", "MaintenanceBackend",
    "MaintenanceReport",
]
