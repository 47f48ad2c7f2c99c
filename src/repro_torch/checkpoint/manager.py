"""Checkpointing: atomic, keep-k, optionally async (the port of
`repro.checkpoint.manager`, in its on-disk format: either package restores
the other's checkpoints).

A checkpoint stores *logical* arrays keyed by tree path ("params/embed",
"opt/m/groups/0/attn/wq/w", ...: nested dict keys joined by "/", as the
reference's ``_flatten_with_paths`` writes them) in ``arrays.npz`` (bf16
stored as f32), plus ``meta.json`` (step, time, user metadata).  Restore
reads them into a template's structure and dtypes, on the template's or a
given device.

Write protocol: write to ``<dir>/tmp.<step>.<pid>/``, then an atomic rename
to ``<dir>/step_<n>``, so a crash mid-save never corrupts the latest
checkpoint; keep the newest ``keep``.

The reference hands its save thread immutable arrays.  The port's
parameters and optimizer state are updated in place by the next step, so
`save` copies every tensor to host numpy before it returns, and only then
starts the thread: an async save is never torn.

Elastic by construction, as the reference: a DTensor leaf (a sharded
run's) is gathered whole before it is written, so the file holds logical
arrays in the reference's format (every rank of the mesh must call
`save`; rank 0 of the process group writes), and `restore(...,
mesh=, placements=)` distributes them onto any other mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch


def _paths(tree, prefix=""):
    """(path, leaf) in sorted-key order, paths joined by "/"."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _writer() -> bool:
    """Whether this process writes: rank 0 of the process group, or a
    process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()  # a collective: every rank calls
        if leaf.dtype == torch.bfloat16:  # npz can't serialize bf16
            leaf = leaf.float()
        return leaf.cpu().numpy().copy()
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _distribute(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def _flatten_with_paths(tree) -> dict:
    """{path: host numpy copy} of every leaf of ``tree``."""
    return {path: _to_numpy(leaf) for path, leaf in _paths(tree)}


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             block: bool = False) -> None:
        arrays = _flatten_with_paths(tree)  # host copies, before returning
        sharded = any(_is_dtensor(leaf) for _, leaf in _paths(tree))
        if sharded and not _writer():
            return  # rank 0 writes the gathered arrays
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, metadata or {}))
            self._thread.start()
        else:
            self._write(step, arrays, metadata or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: dict, metadata: dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"step": step, "time": time.time(), **metadata}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, mesh=None, placements=None):
        """Restore into ``template``'s structure and dtypes: a tensor leaf
        becomes a tensor on ``device`` (default: the template leaf's
        device), any other leaf a numpy array.  With ``mesh`` and
        ``placements`` (a tree of the paths to place, for example
        `launch.mesh.tree_shardings`' of the parameters under "params"),
        each of those leaves becomes a DTensor on that mesh, each rank
        keeping its shard; without them a DTensor leaf of the template
        keeps the template's mesh and placements.
        Returns (tree, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        leaves = []
        where = (dict(_paths(placements)) if placements is not None
                 else {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for key, leaf in _paths(template):
                arr = z[key]
                if isinstance(leaf, torch.Tensor):
                    t = torch.from_numpy(arr).to(leaf.dtype)
                    on = None
                    if mesh is not None and key in where:
                        on, pl = mesh, where[key]
                    elif mesh is None and _is_dtensor(leaf):
                        on, pl = leaf.device_mesh, leaf.placements
                    if on is not None:
                        leaves.append(_distribute(
                            t.to(device if device is not None
                                 else on.device_type), on, pl))
                        continue
                    leaves.append(t.to(device if device is not None
                                       else leaf.device))
                else:
                    dtype = getattr(leaf, "dtype", None)
                    leaves.append(arr.astype(dtype) if dtype is not None
                                  else arr)
        return _unflatten(template, iter(leaves)), meta
