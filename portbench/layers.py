"""Reductions from a traced window to per-layer numbers, shared by the
metric readers in `portbench/metrics/`.  Each takes a `Reading` and returns
a number, or None where the trace holds nothing to read.

A `Reading` is what one traced window gives: its `tracing.Trace`, the
batched slots the window advanced (the fused slot-step kernel's launches
by the program's own counters: eager, captured and replayed), the fused
kernel's launches as [(shapes, count)], and the card's published peaks
(None for a card not in `roofline/peaks.json`)."""
from __future__ import annotations

import dataclasses

from portbench.roofline import bp_slot_step

#: The fused slot-step kernel's name in the device trace.
SLOT_KERNEL = "bp_slot_step_kernel"
#: Device activities that are not kernels.
NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Reading:
    trace: object
    batched_slots: int
    launches: list
    peaks: dict | None


def _kernels(r: Reading):
    return [a for a in r.trace.device if not a[0].startswith(NOT_KERNELS)]


def kernels_per_slot(r: Reading):
    """Device kernels launched per batched slot, every kernel of the window
    (per-run set-up and read-back included)."""
    if r.batched_slots <= 0:
        return None
    return len(_kernels(r)) / r.batched_slots


def remainder_us_per_slot(r: Reading):
    """Device microseconds per batched slot outside the fused slot step."""
    if r.batched_slots <= 0 or not r.trace.named(SLOT_KERNEL):
        return None
    rest = sum(e - s for n, s, e in r.trace.device if SLOT_KERNEL not in n)
    return rest * 1e-3 / r.batched_slots


def slot_kernel_roofline(r: Reading):
    """The fused kernel's share of its roofline, in %: the least time of
    its launches, each at its own shapes, over their device time."""
    launches = r.trace.named(SLOT_KERNEL)
    if not launches or r.peaks is None:
        return None
    least = sum(n * bp_slot_step.least_seconds(shapes, r.peaks)
                for shapes, n in r.launches)
    return 100.0 * least / (sum(e - s for _, s, e in launches) * 1e-9)

