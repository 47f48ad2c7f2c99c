"""The paper's primary contribution, ported: Algorithm 1 (the in-memory
k-bisimulation build) on PyTorch, with its signature stores, the exact
oracle and the state hand-over to and from the JAX package."""
from .partition import (BisimResult, IterationStats, bisim_step, build_bisim,
                        partition_blocks, refines, same_partition)
from .oracle import is_k_bisimilar, oracle_pids
from .sig_store import SigStore, fuse_key, label_key, split_key
from .state import graph_from_numpy, result_from_numpy, result_to_numpy
from . import signatures

__all__ = [
    "BisimResult", "IterationStats", "bisim_step", "build_bisim",
    "partition_blocks", "refines", "same_partition", "is_k_bisimilar",
    "oracle_pids", "SigStore", "fuse_key", "label_key", "split_key",
    "graph_from_numpy", "result_from_numpy", "result_to_numpy",
    "signatures",
]
