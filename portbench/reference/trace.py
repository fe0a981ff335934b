"""The trace simulator's semantics in plain NumPy: one problem at several
query rates as one batch, Poisson arrivals from one uniform stream per seed
(common random numbers across the rates), the regulator's bits from the
same seed keyed by the slot, and the per-slot traces the paper's figures
read: total backlog, cumulative deliveries (all and useful), pairs
computed, and the load balancer's choice n*.
"""
from __future__ import annotations

import numpy as np

from . import noise, slot
from .fleet import CARRY, F32, padded_problem, poisson_table, regulated

TRACES = ("total_queue", "delivered", "delivered_useful", "computed",
          "n_star")


def sweep(topo: dict, policy: str, eps_b: float, lams, T: int, seed: int,
          carry: str = "float32") -> dict:
    """{trace: [L, T] float64} for the rates ``lams`` on ``topo``."""
    L = len(lams)
    NC = len(topo["comp_nodes"])
    pad = {"n_nodes": topo["n_nodes"], "n_edges": len(topo["edges"]),
           "n_comp": NC}
    p = padded_problem([topo] * L, pad)
    hold = CARRY[carry]
    lam = np.asarray(lams, np.float64)
    cdf = poisson_table(lam)
    t = np.arange(T)
    seeds = np.full(T, int(seed), np.int64)
    u = noise.uniform64(seeds, t, noise.SITE_ARRIVAL, 1)[:, 0]         # [T]
    arrivals = (cdf[None, :, :] <= u[:, None, None]).sum(2).astype(F32)
    bits = None
    if regulated(policy):
        bits = (noise.uniform(seeds, t, noise.SITE_REGULATOR, NC)
                < F32(eps_b)).astype(F32)                              # [T, NC]
    eps = np.full((L,), eps_b, F32)
    s = slot.zero_state(L, pad["n_nodes"], NC)
    out = {k: np.zeros((L, T), np.float64) for k in TRACES}
    for j in range(T):
        reg = None if bits is None else np.broadcast_to(bits[j], (L, NC))
        s, m = slot.slot(p, s, arrivals[j], reg, eps)
        s = {k: hold(v) for k, v in s.items()}
        m = {**m, "delivered": s["delivered"],
             "delivered_useful": s["delivered_useful"]}
        for k in TRACES:
            out[k][:, j] = hold(np.asarray(m[k], F32))
    return out
