"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

The package mirrors `repro`'s layout and names (``core``, ``graph``,
``exmem``, ``kernels``, ``obs``, ``models``, ``configs``, ``serve``,
``launch``) so each module's counterpart is easy to find, but it imports
nothing of `repro` and never imports JAX: it keeps its own copies of the
host-side numpy modules it needs.

Every entry point takes an explicit ``device``.  It runs on ``cuda`` unless
the caller asks for ``cpu`` (as the CPU tests do); without a card and
without that request it raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked.

    ``None`` means the card; it raises when ``torch.cuda.is_available()`` is
    false rather than falling back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; pass "
            "device='cpu' to run the plain-PyTorch route on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
