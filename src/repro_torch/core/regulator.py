"""Dummy-packet regulator (paper §III-C, eq. (8)), batched.

Port of `repro.core.regulator`.  Each slot F(t) = A(t)*(1+B(t)) packets are
pushed downstream from the regulator queue Y; what Y cannot cover is made
up with dummy packets.  The Bernoulli(eps_B) draws B(t) are an argument —
the noise seam — so a test can feed the draws JAX made and the engine its
own counter-based ones (`repro_torch.sim.workload`).  Defined beside the
slot step's plain version; `repro_torch.kernels.bp_slot.ref` says why.
"""
from repro_torch.kernels.bp_slot.ref import regulator_push

__all__ = ["regulator_push"]
