"""Reductions from a traced window of prefills to per-layer numbers,
shared by the prefill metrics' readers in `portbench/metrics/`.  Each
takes the harness's `layers.Reading` (its `launches` are the prefill
entry's [(shapes, launches)], `roofline/prefill.prefill_launches`) and
returns a number, or None where the trace holds nothing to read.

Peaks: the harness's `Reading.peaks`, the card's row of
`roofline/peaks.json` (memory, float32 and the tensor cores' dense bf16);
None for a card not there.
"""
from __future__ import annotations

import json

from portbench.roofline import prefill

#: Device-trace names of the kernels (each a part of the kernels' names:
#: the sm90 and the CUDA-core flash kernels; the gate's three paths).
FLASH = "flash_attention"
GATE = "bp_topk_route"


def _shapes(reading, kernel: str) -> list:
    return [s for s, _ in reading.launches if s["kernel"] == kernel]


def _seconds(records) -> float:
    return sum(e - s for _, s, e in records) * 1e-9


def kernel_roofline(reading, name: str, kernel: str, least_seconds):
    """A kernel's share of its roofline, in %: the least time of each
    launch traced (the kernel's device-trace records named ``name``) over
    their device time.  Every launch of the kernel in a cell has one
    shape, so a record the profiler lost counts on neither side."""
    records = reading.trace.named(name)
    got = reading.peaks
    shapes = {json.dumps(s, sort_keys=True) for s in _shapes(reading,
                                                             kernel)}
    if not records or got is None or not shapes:
        return None
    if len(shapes) > 1:
        raise ValueError(f"{kernel}: launches of {len(shapes)} shapes; the "
                         f"roofline pairs one shape with every record")
    least = least_seconds(_shapes(reading, kernel)[0], got)
    return 100.0 * least * len(records) / _seconds(records)


def flash_roofline(reading):
    return kernel_roofline(reading, FLASH, "flash_attention",
                           prefill.flash_least_seconds)


def gate_roofline(reading):
    return kernel_roofline(reading, GATE, "bp_topk_route",
                           prefill.gate_least_seconds)


def _prefills(reading) -> list:
    return [(s, n) for s, n in reading.launches if s["kernel"] == "prefill"]


def remainder_ms(reading):
    """Device milliseconds a prefill outside the flash and gate kernels
    (every other kernel, copy and set of the window)."""
    n = sum(k for _, k in _prefills(reading))
    if not n or not reading.trace.named(FLASH):
        return None
    rest = [a for a in reading.trace.device
            if FLASH not in a[0] and GATE not in a[0]]
    return _seconds(rest) * 1e3 / n


def mfu(reading):
    """The traced prefills' model FLOPs over the window's wall time times
    the peak of their dtype, in %."""
    got = reading.peaks
    steps = _prefills(reading)
    if got is None or not steps or not reading.trace.device:
        return None
    flops = sum(s["flops"] * n for s, n in steps)
    peak = got[prefill.PEAK[steps[0][0]["dtype"]]]
    return 100.0 * flops / (reading.trace.window_s * peak)
