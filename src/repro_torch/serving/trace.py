"""Trace-driven workloads: per-class query streams drawn slot by slot.

Port of `repro.serving.trace`.  A `TraceSpec` declares the live traffic
a serving run faces: a mixture of query classes, each drawing from one of
the registry's arrival models (`fleet.scenarios.ARRIVAL_MODELS`:
poisson, bernoulli_batch, constant, markov_onoff), optionally modulated by
a deterministic diurnal envelope.  Nothing here materializes a [T] trace:
`draw_arrivals` is a per-slot function of (noise, t, TraceState) run
inside the serving slot.  `TraceSpec` is frozen and hashable: it keys the
serving runner's memo, so two runs over one trace share one launcher.

Noise goes through the port's seam (`repro_torch.sim.workload`): each
class's arrival uniform (site `SITE_CLASS_ARRIVAL`) and ON-OFF phase
uniform (`SITE_CLASS_PHASE`), the class index as the element.  Poisson
counts are inverse-CDF draws.  A class with a fixed rate draws from its
own table row ([B, K, W], built once per run, `class_table`); a class
under a diurnal envelope has a rate that moves every slot, so its CDF is
computed in the slot from the current rate (`poisson_cdf`: float64
log-pmf and cumsum over the table's W columns, W fixed by the class's top
rate, so a captured graph replays it).  JAX's ``jax.random.poisson``
agrees with either in distribution only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.fleet.scenarios import (ARRIVAL_MODELS, MMPP_PI_ON,
                                         ModState)
from repro_torch.sim import workload

#: Arrival models whose count is a Poisson draw (they read a CDF row).
POISSON_MODELS = ("poisson", "markov_onoff")


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """One class of the workload mixture.

    ``frac`` is the class's share of the job's offered rate `lam`; shares
    must sum to 1 so capacity sweeps stay comparable across traces.
    """

    name: str
    arrival: str = "poisson"       # ARRIVAL_MODELS key
    frac: float = 1.0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_MODELS:
            raise ValueError(f"unknown arrival model {self.arrival!r}; "
                             f"known: {sorted(ARRIVAL_MODELS)}")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"class frac must be in (0, 1], got {self.frac}")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A named workload: query-class mixture + optional diurnal envelope.

    ``diurnal_period`` > 0 modulates every class's rate by a sinusoid of
    that period (slots) and peak deviation ``diurnal_depth``; the envelope
    has mean 1 over a period, so the long-run offered rate is exactly
    `lam` and delivered QPS stays scoreable against `policy_bound_exact`.
    """

    name: str
    classes: Tuple[QueryClass, ...]
    diurnal_period: int = 0
    diurnal_depth: float = 0.0
    description: str = ""

    def __post_init__(self):
        if not self.classes:
            raise ValueError("a trace needs at least one query class")
        tot = sum(c.frac for c in self.classes)
        if abs(tot - 1.0) > 1e-6:
            raise ValueError(f"class fracs must sum to 1, got {tot}")
        if not 0.0 <= self.diurnal_depth < 1.0:
            raise ValueError("diurnal_depth must be in [0, 1)")

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def enveloped(self) -> bool:
        return self.diurnal_period > 0


@dataclasses.dataclass(frozen=True)
class TraceState:
    """Each sim's per-class arrival phase ([B, K] float32, 1.0 = ON): two
    markov_onoff classes burst independently; memoryless classes never
    read theirs."""

    burst: torch.Tensor

    @staticmethod
    def init(spec: TraceSpec, B: int, device) -> "TraceState":
        return TraceState(torch.ones((B, spec.n_classes),
                                     dtype=torch.float32, device=device))


def envelope(spec: TraceSpec, t: torch.Tensor) -> torch.Tensor | float:
    """Deterministic diurnal rate multiplier at slots t (mean 1)."""
    if spec.diurnal_period <= 0:
        return 1.0
    phase = 2.0 * math.pi * t.to(torch.float32) / spec.diurnal_period
    return (1.0 + spec.diurnal_depth * torch.sin(phase)).to(torch.float32)


def _table_rate(qc: QueryClass, lam):
    """The Poisson rate a class's count is drawn at, given its rate:
    lam / P(ON) for ON-OFF (the count of an ON slot), else lam."""
    return lam / MMPP_PI_ON if qc.arrival == "markov_onoff" else lam


def class_table(spec: TraceSpec, lam, device, width: int = 0
                ) -> torch.Tensor:
    """[B, K, W] float64 Poisson tables of every sim's classes at offered
    rates ``lam`` [B], at least ``width`` columns wide.

    A fixed-rate Poisson class's row is its CDF at ``lam * frac`` (1.0
    beyond its own width); other classes read no row and get 1.0.  Under
    a diurnal envelope every row is 1.0 and the table only fixes W, wide
    enough for the class's top rate ``lam * frac * (1 + depth)``: the slot
    computes the CDF from the current rate (`poisson_cdf`)."""
    lam = np.asarray(lam, np.float32).reshape(-1)
    B, K = lam.size, spec.n_classes
    peak = 1.0 + spec.diurnal_depth if spec.enveloped else 1.0
    rates = np.zeros((B, K))
    top = 0.0
    for k, qc in enumerate(spec.classes):
        if qc.arrival not in POISSON_MODELS:
            continue
        r = _table_rate(qc, (lam * np.float32(qc.frac)).astype(np.float64))
        top = max(top, float(r.max(initial=0.0)) * peak)
        if not spec.enveloped:
            rates[:, k] = r
    width = max(width, workload.poisson_width(top))
    return workload.poisson_table(rates.reshape(-1), device=device,
                                  width=width).reshape(B, K, -1)


def poisson_cdf(rate: torch.Tensor, width: int) -> torch.Tensor:
    """[B, width] float64 Poisson CDFs at rates [B], from the log-pmf:
    cdf[b, k] = sum_{j<=k} exp(j log r - r - lgamma(j + 1)).  The last
    column is 1.0 (the table's truncation) and a rate-0 row is all 1.0."""
    r = rate.to(torch.float64)[:, None]
    k = torch.arange(width, dtype=torch.float64, device=r.device)[None, :]
    pos = r > 0
    safe = torch.where(pos, r, torch.ones_like(r))
    logpmf = k * torch.log(safe) - safe - torch.lgamma(k + 1.0)
    cdf = torch.cumsum(torch.exp(logpmf), -1)
    cdf[:, -1] = 1.0
    return torch.where(pos, cdf, torch.ones_like(cdf))


def draw_arrivals(spec: TraceSpec, lam: torch.Tensor, t: torch.Tensor,
                  tr: TraceState, mod: ModState, u: torch.Tensor,
                  u_phase: torch.Tensor, cdf: torch.Tensor):
    """One slot of per-class query arrivals: ([B, K] arrivals, TraceState').

    ``u`` [B, K] float64 and ``u_phase`` [B, K] float32 are each class's
    arrival and phase uniforms, ``cdf`` [B, K, W] the class tables
    (`class_table`).  Each class runs its registry arrival model verbatim,
    on a `ModState` whose ``burst`` is that class's own phase; the phase
    it returns goes back into ``TraceState.burst[:, k]``."""
    env = envelope(spec, t)
    arrs, phases = [], []
    for k, qc in enumerate(spec.classes):
        lam_k = lam * (qc.frac * env)
        row = cdf[:, k]
        if spec.enveloped and qc.arrival in POISSON_MODELS:
            row = poisson_cdf(_table_rate(qc, lam_k.to(torch.float64)),
                              cdf.shape[-1])
        a, m2 = ARRIVAL_MODELS[qc.arrival](
            lam_k, u[:, k], u_phase[:, k], row,
            mod.replace(burst=tr.burst[:, k]))
        arrs.append(a)
        phases.append(m2.burst)
    return torch.stack(arrs, -1), TraceState(torch.stack(phases, -1))


def class_noise(spec: TraceSpec, seed: torch.Tensor, t: torch.Tensor):
    """One slot's class uniforms from the port's noise: (u [B, K] float64,
    u_phase [B, K] float32); a draw no class reads is zeros."""
    K = spec.n_classes
    kinds = {qc.arrival for qc in spec.classes}
    z = torch.zeros((seed.shape[0], K), device=seed.device)
    u = (workload.uniform64(seed, t, workload.SITE_CLASS_ARRIVAL, K)
         if kinds - {"constant"} else z.double())
    u_phase = (workload.uniform(seed, t, workload.SITE_CLASS_PHASE, K)
               if "markov_onoff" in kinds else z)
    return u, u_phase


# ---------------------------------------------------------------------------
# Trace registry: workloads declared as data, like the scenario registry.
# ---------------------------------------------------------------------------

TRACES: Dict[str, TraceSpec] = {}


def register_trace(spec: TraceSpec) -> TraceSpec:
    if spec.name in TRACES:
        raise ValueError(f"trace {spec.name!r} already registered")
    TRACES[spec.name] = spec
    return spec


def get_trace(name: str) -> TraceSpec:
    try:
        return TRACES[name]
    except KeyError:
        raise KeyError(
            f"unknown trace {name!r}; known: {sorted(TRACES)}") from None


def list_traces() -> list[str]:
    return sorted(TRACES)


register_trace(TraceSpec(
    "steady", (QueryClass("q", "poisson"),),
    description="Single Poisson class — the open-loop fleet workload."))
register_trace(TraceSpec(
    "bursty", (QueryClass("q", "markov_onoff"),),
    description="Single Markov ON-OFF class: correlated bursts, mean rate "
                "exactly lam (the acceptance trace)."))
register_trace(TraceSpec(
    "diurnal_mix", (QueryClass("interactive", "poisson", 0.6),
                    QueryClass("batch", "bernoulli_batch", 0.4)),
    diurnal_period=2000, diurnal_depth=0.3,
    description="Poisson + batch mixture under a mean-1 diurnal envelope."))
register_trace(TraceSpec(
    "bursty_mix", (QueryClass("bursty", "markov_onoff", 0.5),
                   QueryClass("steady", "poisson", 0.5)),
    description="Half bursty, half steady — the fairness stress: shedding "
                "must not starve either class."))
