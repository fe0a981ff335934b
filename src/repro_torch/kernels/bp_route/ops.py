"""Entry point of the routing decision: gather the endpoint backlogs and
run the `bp_route_decide` kernel.

Port of `repro.kernels.bp_route.ops.bp_route_op`.  As in the reference,
the op gathers each link's two endpoint rows of the per-node backlogs and
casts the capacities to float32 (the kernel's contract) before the launch.
"""
from __future__ import annotations

import torch

from .kernel import bp_route_decide
from .ref import bp_route_ref


def bp_route_op(Q: torch.Tensor, edges: torch.Tensor, cap: torch.Tensor):
    """Q: [N, C] per-node class backlogs; edges: [E, 2] integer endpoints;
    cap: [E].  Returns (best class [E] int32, rate [E] float32, direction
    [E] int32)."""
    e = edges.long()
    return bp_route_decide(Q[e[:, 0]].contiguous(), Q[e[:, 1]].contiguous(),
                           cap.to(torch.float32).contiguous())


__all__ = ["bp_route_op", "bp_route_ref", "bp_route_decide"]
