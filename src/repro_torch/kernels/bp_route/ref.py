"""Plain PyTorch version of the per-link backpressure routing decision.

Port of `repro.kernels.bp_route.ref.bp_route_ref`, the function the Pallas
kernel `bp_route_decide` computes: for every link, the class of largest
|qm - ql| (the first on ties, as `jnp.argmax`), the rate (cap when that
differential is non-zero, else 0) and the direction (+1 = m -> l when it
is positive, else -1), in float32 on float32-cast inputs.  Every step is
exact or a single rounded subtraction, so the CUDA kernel equals it bit
for bit.
"""
from __future__ import annotations

import torch


def bp_route_ref(qm: torch.Tensor, ql: torch.Tensor, cap: torch.Tensor):
    """qm/ql [E, C], cap [E] -> (best class [E] int32, rate [E] float32,
    direction [E] int32)."""
    diff = qm.to(torch.float32) - ql.to(torch.float32)
    best = torch.argmax(diff.abs(), dim=1)          # first occurrence
    dmax = torch.gather(diff, 1, best[:, None])[:, 0]
    rate = torch.where(dmax.abs() > 0, cap.to(torch.float32), 0.0)
    dirn = torch.where(dmax > 0, 1, -1).to(torch.int32)
    return best.to(torch.int32), rate, dirn
