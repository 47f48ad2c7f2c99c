"""Host-to-device upload of numpy columns through a fixed ring of pinned
host buffers.

``torch.from_numpy(x).to("cuda")`` on a pageable array takes CUDA's
pageable path: one host thread copies the array through CUDA's own
bounce buffers, and the DMA waits on it.  `PinnedRing.stage`
copies a column chunk by chunk instead.  For each chunk it

* waits on the slot's CUDA event, i.e. until the slot's last DMA has
  finished;
* copies the chunk from the array into the slot (a CPU ``copy_``, which
  runs on torch's intra-op threads with the GIL released);
* sends the slot's copy to the card on the current stream, without
  blocking, and records the slot's event.

So while chunk i is in flight to the card the host fills the next slot.
Nothing synchronizes at the end: work that follows on the same stream is
ordered after the copies, and the host goes on meanwhile.

The ring is `SLOTS` pinned buffers of `SLOT_BYTES` each, made once a
process on the first staged upload (`ring`) and reused by every later
one; its size never depends on the input.  `upload` engages it only on a
card and only for columns of more than `ENGAGE_SLOTS` slots' worth in
all; anything smaller, and every upload to another device, takes the
direct copy.  The slots may be plain CPU tensors and the destination a
CPU tensor: the same chunk and slot rotation then runs without a card.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

# On an H100 host (8 threads) 32 MiB x 3 gave the fastest 6.5 GB upload
# of 8-64 MiB x 2-4 slots: the host's copy into the slots paces the ring.
SLOT_BYTES = 32 << 20
SLOTS = 3
ENGAGE_SLOTS = 4

_ring = None


class PinnedRing:
    """A fixed ring of host staging buffers (1-D uint8 tensors of one
    size), each with the CUDA event of its last copy to the card."""

    def __init__(self, slots):
        self.slots = list(slots)
        self.slot_bytes = self.slots[0].numel()
        self._events = [None] * len(self.slots)
        self._turn = 0
        # one column at a time: two threads' chunks must not share a slot
        self._lock = threading.Lock()

    def stage(self, x: np.ndarray, dst: torch.Tensor) -> int:
        """Copy the 1-D array ``x`` into ``dst`` (a contiguous tensor of
        its length and dtype) through the ring; returns the chunks."""
        itemsize = x.dtype.itemsize
        per = self.slot_bytes // itemsize
        stream = (torch.cuda.current_stream(dst.device) if dst.is_cuda
                  else None)
        chunks = 0
        with self._lock:
            for a in range(0, len(x), per):
                b = min(a + per, len(x))
                i = self._turn
                if self._events[i] is not None:
                    self._events[i].synchronize()
                slot = self.slots[i][:(b - a) * itemsize].view(dst.dtype)
                slot.copy_(torch.from_numpy(np.ascontiguousarray(x[a:b])))
                dst[a:b].copy_(slot, non_blocking=True)
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                    self._events[i] = event
                self._turn = (i + 1) % len(self.slots)
                chunks += 1
        return chunks


def ring() -> PinnedRing:
    """The process's pinned ring, made on first use (and made again only
    if `SLOTS` or `SLOT_BYTES` has changed)."""
    global _ring
    if _ring is None or (len(_ring.slots), _ring.slot_bytes) != (
            SLOTS, SLOT_BYTES):
        _ring = PinnedRing(
            torch.empty(SLOT_BYTES, dtype=torch.uint8, pin_memory=True)
            for _ in range(SLOTS))
    return _ring


def engages(dev: torch.device, nbytes: int) -> bool:
    """Whether an upload of ``nbytes`` to ``dev`` goes through the ring."""
    return dev.type == "cuda" and nbytes > ENGAGE_SLOTS * SLOT_BYTES


def upload(arrays, dev: torch.device):
    """(the 1-D ``arrays`` as tensors on ``dev``, chunks staged through
    the ring: 0 on the direct path)."""
    if not engages(dev, sum(x.nbytes for x in arrays)):
        return [torch.from_numpy(x).to(dev) for x in arrays], 0
    r = ring()
    out = [torch.empty(len(x), dtype=torch.from_numpy(
        np.empty(0, x.dtype)).dtype, device=dev) for x in arrays]
    return out, sum(r.stage(x, t) for x, t in zip(arrays, out))
