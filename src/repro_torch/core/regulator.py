"""Dummy-packet regulator (paper §III-C, eq. (8)), batched.

Port of `repro.core.regulator`.  Each slot F(t) = A(t)*(1+B(t)) packets are
pushed downstream from the regulator queue Y; what Y cannot cover is made
up with dummy packets.  The Bernoulli(eps_B) draws B(t) are an argument —
the noise seam — so a test can feed the draws JAX made and the engine its
own counter-based ones (`repro_torch.sim.workload`).
"""
from __future__ import annotations

from typing import Tuple

import torch


def regulator_push(Y: torch.Tensor, assigned: torch.Tensor,
                   draws: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slot of the regulator for every comp node of every sim.

    Args:
      Y: [B, NC] regulator queue lengths (useful computed results waiting).
      assigned: [B, NC] queries assigned to each node this slot.
      draws: [B, NC] the Bernoulli(eps_B) outcomes B(t) as 0.0/1.0.

    Returns (Y_new, F, dummy), each [B, NC].
    """
    F = assigned * (1.0 + draws.to(Y.dtype))
    useful = torch.minimum(Y, F)
    dummy = F - useful
    return Y - useful, F, dummy
