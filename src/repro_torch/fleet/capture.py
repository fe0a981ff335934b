"""A block of slots captured once into a CUDA graph and replayed.

The capture and the launch accounting shared by the fleet's `GroupLaunch`
(`repro_torch.fleet.engine`) and the trace simulator's `TraceLaunch`
(`repro_torch.sim.simulator`).  A slot step launched while a stream is
captured counts in ``slot_step_fused.captured``, not in ``.launches``; a
replay of the graph launches those kernels again and adds them to
``slot_step_fused.replayed``.  The noise draws' kernel counts alike, in
``counter_hash.captured`` and ``counter_hash.replayed``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bp_slot.kernel import slot_step_fused
from repro_torch.kernels.counter_hash.kernel import counter_hash
from repro_torch.obs import spans

#: Slots one captured CUDA graph advances; a fleet chunk replays it
#: chunk / gcd(chunk, GRAPH_SLOTS) times.  At the fleet's ≈165 kernels a
#: batched slot, a graph of 64 slots holds about 10,500 nodes.
GRAPH_SLOTS = 64
#: The kernel wrappers whose launches a capture counts and a replay adds.
COUNTED = (slot_step_fused, counter_hash)


def launch_device(device) -> torch.device:
    """``device`` with the current CUDA index made explicit, so that two
    spellings of one card key one memoized launch."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class CapturedSlots:
    """One captured block of ``block`` slots: ``graph`` (None until
    `capture`, or after a launch drops it), ``captured`` the launches it
    holds of each `COUNTED` wrapper, by its name, ``n_captures`` the
    captures made and ``replays`` the replays."""

    def __init__(self, block: int):
        self.block = block
        self.graph = None
        self.captured = {f.__name__: 0 for f in COUNTED}
        self.n_captures = 0
        self.replays = 0

    def capture(self, advance) -> None:
        """Capture ``advance()``, the block's slots on static tensors; a
        failed capture raises."""
        with spans.span("graph.capture"):
            graph = torch.cuda.CUDAGraph()
            before = [f.captured for f in COUNTED]
            with torch.cuda.graph(graph):
                advance()
        self.captured = {f.__name__: f.captured - b
                         for f, b in zip(COUNTED, before)}
        self.graph = graph
        self.n_captures += 1

    def replay(self, n: int = 1) -> None:
        """``n`` replays of the captured block, back to back."""
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        for f in COUNTED:
            f.replayed += n * self.captured[f.__name__]
