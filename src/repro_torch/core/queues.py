"""Batched queue state for the backpressure network-computation system.

Port of `repro.core.queues`.  The JAX package steps one network and gets
its fleet from `vmap`; here every leaf carries a leading fleet axis
``[B]`` instead, so one call advances every simulation of a batch.

Class index convention: i=0 processed, i=1 raw from s1, i=2 raw from s2.
Queues are *fluid* (float32).

State components (paper notation, per simulation b):
  Q[b, k, i, n]   : data queue at node k, class (i, n)    (Q_k^{(i,n)})
  Ddum[b, k, n]   : dummy-packet content of Q[b, k, 0, n]
  X[b, n, i]      : raw packets of source i+1 at computation node n
  Y[b, n]         : regulator queue of computed results
  H[b, n]         : virtual admission queue
  cum_arr[b, n, i]: cumulative raw arrivals into X[b, n, i] (FIFO pairing)
  cum_comb[b, n]  : cumulative pairs combined at n
  delivered / delivered_useful : [B] cumulative processed packets at d

The delivery counters are compensated (Kahan) float32 sums, updated only
by the slot step: `kahan_add` in its plain version, the same three
operations in the fused kernel (`bp_slot_step.cu`, built with -fmad=false,
which keeps the compensation term alive; the reference guards it in
`tests/test_fleet.py`).  `kahan_add` is defined beside the plain slot step;
`repro_torch.kernels.bp_slot.ref` says why.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.bp_slot.ref import kahan_add  # noqa: F401

from .graph import ComputeProblem


# ---------------------------------------------------------------------------
# Streaming stability verdict (windowed backlog-drift accumulators)
# ---------------------------------------------------------------------------

VERDICT_UNDECIDED, VERDICT_STABLE, VERDICT_UNSTABLE = 0, 1, 2
VERDICT_NAMES = ("UNDECIDED", "STABLE", "UNSTABLE")


@dataclasses.dataclass(frozen=True)
class DriftStats:
    """Per-sim drift statistics of the streaming verdict; every field [B]."""

    q_mark: torch.Tensor        # f32 total backlog at the burn-in anchor
    useful_mark: torch.Tensor   # f32 delivered_useful at the anchor
    last_drift: torch.Tensor    # f32 anchored per-slot drift, last boundary
    last_rate: torch.Tensor     # f32 anchored useful rate, last boundary
    stable_run: torch.Tensor    # i32 consecutive stable-evidence windows
    unstable_run: torch.Tensor  # i32 consecutive unstable-evidence windows
    verdict: torch.Tensor       # i32 VERDICT_UNDECIDED/STABLE/UNSTABLE
    decided_at: torch.Tensor    # i32 slot count at which the verdict latched

    @staticmethod
    def zero(B: int, device) -> "DriftStats":
        def z(dtype):
            return torch.zeros((B,), dtype=dtype, device=device)
        f, i = torch.float32, torch.int32
        return DriftStats(z(f), z(f), z(f), z(f), z(i), z(i), z(i), z(i))


def drift_verdict_update(d: DriftStats, t: torch.Tensor, total_q: torch.Tensor,
                         delivered_useful: torch.Tensor, lam: torch.Tensor, *,
                         window: int, burn_in: int, k_stable: int,
                         k_unstable: int, drift_tol: float,
                         gap_tol: float) -> DriftStats:
    """One slot of the streaming stability verdict, batched over [B].

    Same rules as `repro.core.queues.drift_verdict_update`: ``t`` [B] i32 is
    each sim's slot index, ``total_q``/``delivered_useful`` its post-slot
    backlog and useful deliveries, ``lam`` [B] its offered rate."""
    boundary = (t + 1) % window == 0
    anchor = (t + 1) == burn_in
    counted = boundary & (t + 1 >= burn_in + 2 * window)
    scale = torch.clamp(lam, min=1.0)
    elapsed = torch.clamp((t + 1 - burn_in).to(torch.float32), min=1.0)
    drift_a = (total_q - d.q_mark) / elapsed
    rate_a = (delivered_useful - d.useful_mark) / elapsed
    gap_a = lam - rate_a
    stable_ev = (drift_a <= drift_tol * scale) & (gap_a <= gap_tol * scale)
    unstable_ev = (drift_a >= 2.0 * drift_tol * scale) & \
        (gap_a >= gap_tol * scale)
    zero = torch.zeros_like(d.stable_run)
    s_run = torch.where(counted,
                        torch.where(stable_ev, d.stable_run + 1, zero),
                        d.stable_run)
    u_run = torch.where(counted,
                        torch.where(unstable_ev, d.unstable_run + 1, zero),
                        d.unstable_run)
    newly = torch.where(s_run >= k_stable, VERDICT_STABLE,
                        torch.where(u_run >= k_unstable, VERDICT_UNSTABLE,
                                    VERDICT_UNDECIDED)).to(torch.int32)
    decide = counted & (d.verdict == VERDICT_UNDECIDED) & \
        (newly != VERDICT_UNDECIDED)
    return DriftStats(
        q_mark=torch.where(anchor, total_q, d.q_mark),
        useful_mark=torch.where(anchor, delivered_useful, d.useful_mark),
        last_drift=torch.where(counted, drift_a, d.last_drift),
        last_rate=torch.where(counted, rate_a, d.last_rate),
        stable_run=s_run, unstable_run=u_run,
        verdict=torch.where(decide, newly, d.verdict),
        decided_at=torch.where(decide, (t + 1).to(torch.int32), d.decided_at),
    )


@dataclasses.dataclass(frozen=True)
class NetState:
    Q: torch.Tensor                  # [B, N, 3, NC]
    Ddum: torch.Tensor               # [B, N, NC]
    X: torch.Tensor                  # [B, NC, 2]
    Y: torch.Tensor                  # [B, NC]
    H: torch.Tensor                  # [B, NC]
    cum_arr: torch.Tensor            # [B, NC, 2]
    cum_comb: torch.Tensor           # [B, NC]
    delivered: torch.Tensor          # [B] processed packets (incl. dummies)
    delivered_useful: torch.Tensor   # [B]
    delivered_c: torch.Tensor        # [B] Kahan compensation of `delivered`
    delivered_useful_c: torch.Tensor  # [B] ... and of `delivered_useful`


@dataclasses.dataclass(frozen=True)
class StaticProblem:
    """The constant numpy arrays describing one (unpadded) ComputeProblem.

    `fleet.batching.pad_problem` embeds it into padded, batched tensors;
    the slot step itself only ever sees a `PaddedProblem`."""

    n_nodes: int
    n_comp: int
    edges: np.ndarray          # [E,2] int32
    edge_cap: np.ndarray       # [E] float32
    s1: int
    s2: int
    dest: int
    comp_nodes: np.ndarray     # [NC] int32
    comp_caps: np.ndarray      # [NC] float32
    sink: np.ndarray           # [N, 3, NC] bool: Q_k^{(i,n)} is 0 by convention

    @staticmethod
    def build(problem: ComputeProblem) -> "StaticProblem":
        N = problem.graph.n_nodes
        NC = problem.n_comp
        sink = np.zeros((N, 3, NC), dtype=bool)
        for j, n in enumerate(problem.comp_nodes):
            sink[n, 1, j] = True          # raw packets terminate at their comp node
            sink[n, 2, j] = True
            sink[problem.dest, 0, j] = True   # processed packets terminate at d
        return StaticProblem(
            n_nodes=N,
            n_comp=NC,
            edges=problem.graph.edges.astype(np.int32),
            edge_cap=problem.graph.capacity.astype(np.float32),
            s1=problem.s1,
            s2=problem.s2,
            dest=problem.dest,
            comp_nodes=np.asarray(problem.comp_nodes, dtype=np.int32),
            comp_caps=np.asarray(problem.comp_caps, dtype=np.float32),
            sink=sink,
        )


def init_state(pp) -> NetState:
    """All-zero state for every sim of a batched `PaddedProblem`."""
    B, N, NC = pp.batch, pp.n_nodes, pp.n_comp
    dev = pp.edges.device

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return NetState(Q=z(B, N, 3, NC), Ddum=z(B, N, NC), X=z(B, NC, 2),
                    Y=z(B, NC), H=z(B, NC), cum_arr=z(B, NC, 2),
                    cum_comb=z(B, NC), delivered=z(B),
                    delivered_useful=z(B), delivered_c=z(B),
                    delivered_useful_c=z(B))
