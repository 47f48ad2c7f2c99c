"""Roofline terms of one step on NVIDIA H100s (the port of
`repro.launch.roofline`, re-derived for the card).

compute    = FLOPs a device / PEAK_FLOPS          [s]
memory     = bytes a device / HBM_BW              [s]
collective = collective bytes a device / LINK_BW  [s]

Every quantity is per device (`hlo_stats.StepCounter` counts a rank's
local ops), so the reference's division by chips cancels here too.

The constants are the H100 SXM5's, from NVIDIA's H100 Tensor Core GPU
datasheet:
  * dense BF16 tensor-core peak: 989.4 TFLOP/s (the datasheet's 1,979
    TFLOP/s is with 2:4 sparsity, which no kernel here uses);
  * HBM3 bandwidth: 3.35 TB/s;
  * NVLink: 900 GB/s a GPU, the sum of both directions (18 links of
    50 GB/s bidirectional).  A ring collective's wire bytes leave a rank
    in one direction while as many arrive, so the term divides by one
    direction's 450 GB/s.  An NVLink Switch System joins up to 256 H100s
    at this rate, the single-pod 16x16 mesh; the multi-pod mesh's pod
    axis would cross InfiniBand, which this one-rate model (the
    reference's too) does not separate.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989.4e12     # dense bf16 FLOP/s per H100 SXM5
HBM_BW = 3.35e12          # HBM3 bytes/s per H100 SXM5
LINK_BW = 900e9 / 2       # NVLink bytes/s per GPU, one direction


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: dict
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self, model_flops_global: float) -> float:
        """useful_compute_time / roofline_step_time — the perf score."""
        useful = model_flops_global / self.chips / PEAK_FLOPS
        return useful / max(self.step_time_s, 1e-30)

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "chips": self.chips, "step_time_s": self.step_time_s,
        }


def analyze(stats, chips: int) -> Roofline:
    """Roofline terms from a step's `hlo_stats.HloStats` (per device)."""
    return Roofline(
        compute_s=stats.flops / PEAK_FLOPS,
        memory_s=stats.bytes / HBM_BW,
        collective_s=stats.collective_bytes / LINK_BW,
        flops_per_device=stats.flops,
        bytes_per_device=stats.bytes,
        collective_bytes_per_device=stats.collective_bytes,
        collective_breakdown={**stats.collectives,
                              "counts": stats.collective_counts},
        chips=chips)


def measured_fraction(model_flops_global: float, chips: int,
                      step_s: float) -> float:
    """The useful compute time at the peak over a measured step time: the
    share of the chips' bf16 peak that a step's model FLOPs reach."""
    return model_flops_global / chips / PEAK_FLOPS / step_s


def memory_summary(counter, args, outputs) -> dict:
    """The reference's memory keys from a `hlo_stats.StepCounter` that ran
    a step on ``args`` and returned ``outputs``: the arguments' bytes, the
    outputs' new storages, those that alias an argument (updated in
    place), the rest of the high-water mark, and that mark."""
    arg_bytes = counter.storage_bytes(args)
    out_bytes = counter.storage_bytes(outputs)
    both = counter.storage_bytes((args, outputs))
    alias = arg_bytes + out_bytes - both
    peak = int(counter.peak)
    return {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(max(peak - arg_bytes - out_bytes + alias, 0)),
        "alias_bytes": int(alias),
        "peak_estimate_bytes": peak,
    }
