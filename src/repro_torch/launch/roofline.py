"""Roofline terms of a dry-run cell on the H100.

Port of `repro.launch.roofline`, its peaks the H100 SXM's in place of the
reference's TPU v5e constants:

  compute term    = sum over dtypes of FLOPs(dtype) / peak(dtype)
  memory term     = bytes / HBM bandwidth

per device.  The port's counts come from a trace of its step on meta
tensors (`launch.dryrun.TraceCounter`, read by `from_trace`) in place of
XLA's cost analysis of a compiled executable.  Matrix products on float32
operands are priced at the float32 peak of the CUDA cores: the port keeps
`torch.backends.cuda.matmul.allow_tf32` False (torch's default, which
`chip_smoke.py` asserts), so no float32 product runs on the tensor cores.

The reference's third term, collective bytes parsed from optimized HLO
over the link bandwidth, has no input here: the port traces one device,
which has no collectives, so a summary states that term as 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM5 80 GB, per card, from NVIDIA's H100 Tensor Core GPU data
# sheet (at its 700 W limit):
HBM_BW = 3.35e12           # bytes/s: HBM3 memory bandwidth
PEAK_FLOPS = {
    "bfloat16": 989e12,    # dense BF16 on the tensor cores (1,979 sparse)
    "float32": 67e12,      # FP32 on the CUDA cores (no TF32, see above)
}


@dataclasses.dataclass(frozen=True)
class Roofline:
    #: FLOPs by operand dtype (torch's name).
    flops_by_dtype: Dict[str, float]
    bytes_per_device: float

    @property
    def flops_per_device(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def compute_s(self) -> float:
        unpriced = sorted(set(self.flops_by_dtype) - set(PEAK_FLOPS))
        if unpriced:
            raise KeyError(f"no H100 peak for matrix products in {unpriced}")
        return sum(f / PEAK_FLOPS[dt] for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    def summary(self) -> dict:
        """The reference's keys; the collective ones 0 (one device)."""
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": 0.0, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": 0.0, "coll_breakdown": {},
            "flops_by_dtype": self.flops_by_dtype,
        }


def from_trace(counter) -> Roofline:
    """The roofline of one device's traced step: ``counter`` holds FLOPs
    by dtype (``.flops``) and bytes (``.bytes``)."""
    return Roofline(flops_by_dtype=dict(counter.flops),
                    bytes_per_device=float(counter.bytes))


def model_flops(cfg, shape, n_params: int, active_params: int) -> float:
    """6*N*D (train) / 2*N*D (inference) with D = tokens in the step."""
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        return 6.0 * active_params * D
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * active_params * D
    D = shape.global_batch                      # decode: one token per seq
    return 2.0 * active_params * D
