"""Admission control: shed queries on drift toward instability, re-admit
on recovery.

Port of `repro.serving.admission`, batched over a leading fleet axis
[B].  The gate thresholds on the same Lyapunov-drift evidence the
streaming verdict latches on, but reversibly: an overloaded network sheds,
a recovered one re-admits.  Overload evidence is a conjunction, as in the
verdict: the backlog grows (windowed drift slope >= ``shed_tol`` x
max(lam, 1)) and delivery falls behind admission (windowed admitted
minus delivered gap >= ``gap_tol`` x max(lam, 1)); the verdict's
``unstable_run`` streak corroborates the first close only.  The gate moves
only at admission-window boundaries after a burn-in, needs ``k_shed``
overloaded windows to close and ``k_readmit`` recovered ones to open, and
a flip resets the opposing run, so consecutive flips are at least
min(k_shed, k_readmit) windows apart.  Shedding is class-uniform: one gate
multiplies every class's arrivals, so no class starves.

Everything here is elementwise float32 in the reference's order (Kahan
pairs through `kernels.bp_slot.ref.kahan_add`), so both functions are
bit-exact against the reference on the same inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.bp_slot.ref import kahan_add


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Gate parameters.  Frozen/hashable: keys the serving-runner memo.

    ``window <= 0`` resolves to the runner's chunk length, aligning gate
    decisions with the boundaries the engine's host loop can observe (the
    convention of `VerdictConfig.window`).
    """

    window: int = 0           # slots between gate decisions
    burn_in: int = 0          # slots before evidence counts; <= 0 -> 2 windows
    shed_tol: float = 0.10    # windowed drift slope that reads as overload,
                              # x max(lam, 1)
    gap_tol: float = 0.05     # windowed admitted-vs-delivered gap that
                              # corroborates overload, x max(lam, 1)
    readmit_tol: float = 0.02  # slope at or below this reads as recovered
    k_shed: int = 2           # consecutive overloaded windows to close
    k_readmit: int = 2        # consecutive recovered windows to reopen


DEFAULT_ADMISSION = AdmissionConfig()


@dataclasses.dataclass(frozen=True)
class AdmissionState:
    """Every sim's gate state ([B]) and per-class admitted/shed counters
    ([B, K], Kahan-compensated: admitted mass is the latency ring's
    A-curve, so it must stay exact over long horizons)."""

    gate: torch.Tensor        # [B] f32, 1.0 = admitting, 0.0 = shedding
    q_mark: torch.Tensor      # [B] backlog at the last admission boundary
    a_mark: torch.Tensor      # [B] admitted total at the last boundary
    d_mark: torch.Tensor      # [B] delivered_useful at the last boundary
    over_run: torch.Tensor    # [B] i32 consecutive overloaded windows
    under_run: torch.Tensor   # [B] i32 consecutive recovered windows
    flips: torch.Tensor       # [B] i32 gate transitions so far
    last_flip: torch.Tensor   # [B] i32 slot of the last transition (-1: none)
    last_slope: torch.Tensor  # [B] windowed drift slope at the last boundary
    admitted: torch.Tensor    # [B, K] per-class admitted mass
    admitted_c: torch.Tensor  # [B, K] Kahan compensation
    shed: torch.Tensor        # [B, K] per-class shed mass
    shed_c: torch.Tensor      # [B, K]
    gate_slots: torch.Tensor  # [B] slots spent with the gate open

    @staticmethod
    def zero(B: int, n_classes: int, device) -> "AdmissionState":
        f = dict(dtype=torch.float32, device=device)
        i = dict(dtype=torch.int32, device=device)

        def z():
            return torch.zeros((B,), **f)

        def zk():
            return torch.zeros((B, n_classes), **f)

        return AdmissionState(
            gate=torch.ones((B,), **f), q_mark=z(), a_mark=z(), d_mark=z(),
            over_run=torch.zeros((B,), **i), under_run=torch.zeros((B,), **i),
            flips=torch.zeros((B,), **i),
            last_flip=torch.full((B,), -1, **i), last_slope=z(),
            admitted=zk(), admitted_c=zk(), shed=zk(), shed_c=zk(),
            gate_slots=z())

    def replace(self, **kw) -> "AdmissionState":
        return dataclasses.replace(self, **kw)


def admission_admit(adm: AdmissionState, class_arrivals: torch.Tensor):
    """Apply every sim's gate to one slot's per-class arrivals [B, K].

    Returns ``(state', admitted_total [B])``: the mass that enters the
    network this slot."""
    admitted_k = class_arrivals * adm.gate[:, None]
    shed_k = class_arrivals - admitted_k
    a, ac = kahan_add(adm.admitted, adm.admitted_c, admitted_k)
    s, sc = kahan_add(adm.shed, adm.shed_c, shed_k)
    adm2 = adm.replace(admitted=a, admitted_c=ac, shed=s, shed_c=sc,
                       gate_slots=adm.gate_slots + adm.gate)
    return adm2, admitted_k.sum(-1)


def admission_update(cfg: AdmissionConfig, adm: AdmissionState,
                     t: torch.Tensor, total_q: torch.Tensor,
                     delivered_useful: torch.Tensor, lam: torch.Tensor,
                     drift, *, window: int, burn_in: int) -> AdmissionState:
    """One slot of the gate machinery; the gate only moves at boundaries.

    Called with the post-slot backlog, cumulative useful deliveries and
    the sims' post-slot `DriftStats` (its ``unstable_run`` streak is shed
    evidence), each [B]; ``t`` [B] the slot indices.  ``window``/
    ``burn_in`` are the resolved admission window and burn-in."""
    boundary = (t + 1) % window == 0
    counted = boundary & (t + 1 >= burn_in)
    scale = torch.clamp(lam, min=1.0)
    admitted_total = adm.admitted.sum(-1)
    slope = (total_q - adm.q_mark) / window
    gap = (admitted_total - adm.a_mark
           - (delivered_useful - adm.d_mark)) / window
    # The verdict's anchored streak corroborates the FIRST close only
    # (last_flip < 0): after any intervention it keeps scoring `lam`
    # against a history the gate altered, so it must not re-trip the gate.
    over_ev = ((slope >= cfg.shed_tol * scale)
               & (gap >= cfg.gap_tol * scale)) | \
        ((drift.unstable_run >= 1) & (adm.last_flip < 0))
    under_ev = slope <= cfg.readmit_tol * scale
    zero = torch.zeros_like(adm.over_run)
    over = torch.where(counted, torch.where(over_ev, adm.over_run + 1, zero),
                       adm.over_run)
    under = torch.where(counted,
                        torch.where(under_ev, adm.under_run + 1, zero),
                        adm.under_run)
    close = counted & (adm.gate > 0.5) & (over >= cfg.k_shed)
    open_ = counted & (adm.gate <= 0.5) & (under >= cfg.k_readmit)
    flip = close | open_
    return adm.replace(
        gate=torch.where(close, torch.zeros_like(adm.gate),
                         torch.where(open_, torch.ones_like(adm.gate),
                                     adm.gate)),
        q_mark=torch.where(boundary, total_q, adm.q_mark),
        a_mark=torch.where(boundary, admitted_total, adm.a_mark),
        d_mark=torch.where(boundary, delivered_useful, adm.d_mark),
        # A flip restarts the opposing evidence run from scratch: the
        # hysteresis that keeps consecutive flips >= k windows apart.
        over_run=torch.where(open_, zero, over),
        under_run=torch.where(close, zero, under),
        flips=adm.flips + flip.to(torch.int32),
        last_flip=torch.where(flip, (t + 1).to(torch.int32), adm.last_flip),
        last_slope=torch.where(boundary, slope, adm.last_slope),
    )
