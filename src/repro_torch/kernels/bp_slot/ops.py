"""Full per-edge routing decision on top of the bp_slot kernels.

Port of `repro.kernels.bp_slot.ops`, batched over the fleet axis.
`slot_route_op` takes the raw [B, N, 3, NC] queue tensor plus the edge list
and returns (best_class, best_comp, direction, rate) per edge through the
`slot_route_decide` wrapper (the CUDA kernel on a CUDA tensor);
`slot_route_op_ref` computes the same from the plain version.
"""
from __future__ import annotations

import torch

from .kernel import slot_route_decide
from .ref import slot_route_ref


def _decision(Q, edges, cap, route):
    B, N, _, NC = Q.shape
    Qf = Q.reshape(B, N, 3 * NC)
    m = edges[..., 0].to(torch.int32).contiguous()
    l = edges[..., 1].to(torch.int32).contiguous()
    best, dmax = route(Qf, m, l)
    rate = torch.where(dmax.abs() > 0, cap.to(Qf.dtype),
                       torch.zeros_like(dmax))
    dirn = torch.where(dmax > 0, 1, -1).to(torch.int32)
    return best // NC, best % NC, dirn, rate


def slot_route_op(Q: torch.Tensor, edges: torch.Tensor, cap: torch.Tensor):
    """Q: [B, N, 3, NC]; edges: [B, E, 2]; cap: [B, E].

    Returns (best_class [B, E] int32 in 0..2, best_comp [B, E] int32,
    direction [B, E] int32 with +1 = m->l, rate [B, E] float32)."""
    return _decision(Q, edges, cap, slot_route_decide)


def slot_route_op_ref(Q: torch.Tensor, edges: torch.Tensor, cap: torch.Tensor):
    """Plain version of `slot_route_op` (builds the [B, E, 3*NC] tensor)."""
    return _decision(Q, edges, cap, slot_route_ref)
