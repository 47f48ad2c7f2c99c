"""Cluster bring-up: start `torch.distributed` from the environment.

The port of `repro.launch.cluster`.  Call `init_cluster()` first thing in
every process of a run; it starts the default process group and returns
(rank, world_size).  Resolution order: torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) >
Slurm's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, the first
host of ``SLURM_JOB_NODELIST``) > a one-rank group in this process, the
reference's single-process case.

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.bisim --distributed \
        --ranking bucketed --nodes 1000000 --edges 8000000

The backend is explicit: ``nccl`` on the card (one rank a card), ``gloo``
on the CPU, and ``gloo`` on the card only when the caller asks for it.
That is the only way several ranks share one card (NCCL refuses two
ranks on one GPU); gloo moves CUDA tensors through host memory itself.
"""
from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from .. import resolve_device

BACKENDS = ("nccl", "gloo")
SLURM_PORT = 12345  # the reference's coordinator port under Slurm


def _first_host(nodelist: str) -> str:
    """The first host of a Slurm node list: ``gpu[07-09,12],cpu1`` ->
    ``gpu07``."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist)
    if m is None:
        raise ValueError(f"cannot read SLURM_JOB_NODELIST={nodelist!r}")
    prefix, ranges = m.groups()
    return prefix if ranges is None else (
        prefix + re.split(r"[-,]", ranges, maxsplit=1)[0])


def default_backend(device=None, backend=None) -> str:
    """``backend``, checked, or the device's default: ``nccl`` on the
    card, ``gloo`` on the CPU."""
    dev = resolve_device(device)
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs the card; use gloo with "
                         "device='cpu'")
    return backend


def launched_world() -> int:
    """The world size the launcher gave this process (torchrun's
    ``WORLD_SIZE``, else Slurm's ``SLURM_NTASKS``, else 1), read before
    any group starts, in `init_cluster`'s order."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return int(env["WORLD_SIZE"])
    if "SLURM_JOB_NODELIST" in env:
        return int(env.get("SLURM_NTASKS", "1"))
    return 1


def init_cluster(device=None, backend=None):
    """Start the default process group; returns (rank, world_size).

    ``device`` is where the ranks compute (the card unless ``cpu`` is
    asked; it raises without one) and picks the backend unless
    ``backend`` names it.  On the card each rank's current device becomes
    ``cuda:{local rank % cards}``.  A group that is already started is
    returned as it is.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = default_backend(device, backend)
    env = os.environ
    kwargs = {}
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        kwargs["init_method"] = "env://"
    elif "SLURM_JOB_NODELIST" in env:
        rank = int(env.get("SLURM_PROCID", "0"))
        world = int(env.get("SLURM_NTASKS", "1"))
        kwargs["init_method"] = (
            f"tcp://{_first_host(env['SLURM_JOB_NODELIST'])}:"
            f"{env.get('MASTER_PORT', SLURM_PORT)}")
        env.setdefault("LOCAL_RANK", env.get("SLURM_LOCALID", "0"))
    else:
        rank, world = 0, 1
        kwargs["store"] = dist.HashStore()  # one rank: no rendezvous
    if resolve_device(device).type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    return rank, world
