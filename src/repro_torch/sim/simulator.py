"""Slot-level trace simulator (the Fig. 5b/5c path).

Port of `repro.sim.simulator`.  `simulate` runs one problem for T slots and
keeps [T] traces; `sweep_rates` runs one problem at several query rates as
one batch (the reference's `vmap` over lambda) and keeps [L, T] traces.
Both run on CUDA unless the caller passes ``device="cpu"``.

Noise comes from the port's counter-based stream keyed by ``seed``: every
rate of a sweep sees the same uniforms (common random numbers), each turned
into counts by its own Poisson table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.policies import PolicyConfig, slot_step
from repro_torch.core.queues import NetState, init_state
from repro_torch.device import resolve_device
from repro_torch.fleet.batching import PadDims, pad_leaves, from_leaves
from . import workload


class SimResult(NamedTuple):
    final_state: NetState         # batched [B, ...] (B = 1 for `simulate`)
    total_queue: torch.Tensor     # [..., T] backlog trajectory
    delivered: torch.Tensor       # [..., T] cumulative processed packets at d
    delivered_useful: torch.Tensor  # [..., T]
    computed: torch.Tensor        # [..., T] per-slot computations
    n_star: torch.Tensor          # [..., T] chosen comp node index

    @property
    def avg_queue(self) -> torch.Tensor:
        """Time-average total backlog (the paper's stability metric)."""
        return self.total_queue.mean(-1)

    def useful_rate(self, window: int | None = None) -> torch.Tensor:
        """Delivered-useful throughput over the trailing ``window`` slots
        (the baseline is the count at the last slot before the window)."""
        d = self.delivered_useful
        T = d.shape[-1]
        if window is None or window >= T:
            return d[..., -1] / T
        start = T - 1 - window
        return (d[..., -1] - d[..., start]) / window


def _run(problem: ComputeProblem, cfg: PolicyConfig, arrivals: torch.Tensor,
         seed: int, reg_draws: torch.Tensor | None, dev) -> SimResult:
    """Run every row of ``arrivals`` [B, T] on the same problem."""
    B, T = arrivals.shape
    dims = PadDims.of([problem])
    pp = from_leaves([pad_leaves(problem, dims)] * B, dims.n_nodes,
                     dims.n_comp, dev)
    NC = pp.n_comp
    eps = torch.full((B,), cfg.eps_b, dtype=torch.float32, device=dev)
    seeds = torch.full((B,), int(seed), dtype=torch.long, device=dev)
    arrivals = arrivals.to(device=dev, dtype=torch.float32)
    traces = torch.zeros((5, B, T), dtype=torch.float32, device=dev)
    state = init_state(pp)
    for t in range(T):
        reg = None
        if cfg.use_regulator:
            if reg_draws is not None:
                reg = reg_draws[:, t].to(device=dev, dtype=torch.float32)
            else:
                tt = torch.full((B,), t, dtype=torch.long, device=dev)
                u = workload.uniform(seeds, tt, workload.SITE_REGULATOR, NC)
                reg = (u < eps[:, None]).to(torch.float32)
        state, m = slot_step(pp, cfg, state, arrivals[:, t], reg, eps)
        traces[:, :, t] = torch.stack([
            m["total_queue"], m["delivered"], m["delivered_useful"],
            m["computed"], m["n_star"].to(torch.float32)])
    return SimResult(state, traces[0], traces[1], traces[2], traces[3],
                     traces[4].to(torch.int32))


def simulate(problem: ComputeProblem, cfg: PolicyConfig, lam: float, T: int,
             seed: int = 0, arrivals: torch.Tensor | None = None,
             reg_draws: torch.Tensor | None = None,
             device=None) -> SimResult:
    """Run T slots with Poisson(lam) arrivals (or a supplied [T] trace and,
    for regulated policies, optional [T, NC] regulator draws); traces are
    [T]."""
    dev = resolve_device(device)
    if arrivals is None:
        arrivals = workload.poisson_arrivals([lam], T, seed, dev)[0]
    arrivals = torch.as_tensor(arrivals)
    if arrivals.shape[0] != T:
        raise ValueError(
            f"arrivals trace has {arrivals.shape[0]} slots but T={T}")
    res = _run(problem, cfg, arrivals[None], seed,
               None if reg_draws is None else torch.as_tensor(reg_draws)[None],
               dev)
    return SimResult(res.final_state, *(x[0] for x in res[1:]))


def sweep_rates(problem: ComputeProblem, cfg: PolicyConfig, lams, T: int,
                seed: int = 0, device=None) -> SimResult:
    """The full simulation at every rate of ``lams`` as one batch
    (Fig. 5b); traces are [L, T]."""
    dev = resolve_device(device)
    lams = [float(x) for x in lams]
    arrivals = workload.poisson_arrivals(lams, T, seed, dev)
    return _run(problem, cfg, arrivals, seed, None, dev)
