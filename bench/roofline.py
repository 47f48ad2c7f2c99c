"""The peaks a kernel's share is taken against, and the bytes the
benchmark counts for each kernel call.

H100 SXM5, NVIDIA's data sheet: 80 GB of HBM3 at 3.35 TB/s.  Those
figures assume the card's full 700 W; a share is reported with the
card's power limit beside it (`power_limit_w`), since a card set lower
runs slower under load.
"""
from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 device memory rate (data sheet)


def fold_flat_bytes(lanes: int, rows: int) -> int:
    """Bytes one ``fold_flat`` call needs: each lane's (eLabel, pId, src)
    int32 and valid bool read once (13 B), each row's two u32 output
    words written once (8 B).  The zeroing of the output is a memset of
    its own, outside the kernel's time."""
    return 13 * int(lanes) + 8 * int(rows)


def bound_s(nbytes: float) -> float:
    """The least time the card's memory takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
