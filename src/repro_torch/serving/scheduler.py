"""The serving scheduler: trace -> admission -> slot step -> latency.

Port of `repro.serving.scheduler`.  `make_serving_runner` is the serving
twin of `fleet.engine.make_stream_runner`: a memoized `ServingRunner` per
(policy, trace, admission, shapes) with the same chunked surface
(`init_carry`, `slot`, `advance`, `chunk_step`, `finalize`, `probe`), so
`fleet.engine.GroupLaunch` drives it as it drives the fleet (on CUDA one
captured graph of 64 slots replayed per chunk).  The batch axis [B] takes
the place of the reference's `vmap`.

One slot of serving, in the reference's order:

  1. the trace draws per-class query arrivals (`serving.trace`),
  2. the admission gate admits or sheds them uniformly
     (`serving.admission`),
  3. the event model perturbs capacities (the fleet's event chains),
  4. `slot_step` makes the routing, load-balance and regulator decision
     (on CUDA tensors one launch of the fused `bp_slot_step.cu`),
  5. the fleet's online statistics and drift verdict update,
  6. the latency accumulator stamps the admitted curve and bins the
     delivered mass by FIFO sojourn (`core.latency`), and the gate
     re-evaluates at window boundaries.

Serving never freezes a sim: there is no early stop.  `slot` takes
explicit ``class_arrivals`` [B, K] and ``reg_draws`` [B, NC], the noise
seam the parity tests feed with JAX's noise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core.latency import (LatencyStats, latency_mean,
                                      latency_quantiles, latency_update)
from repro_torch.core.policies import PolicyConfig, slot_step
from repro_torch.core.queues import (DriftStats, NetState, VERDICT_UNDECIDED,
                                     init_state)
from repro_torch.device import tree_leaves
from repro_torch.fleet.batching import PaddedProblem
from repro_torch.fleet.engine import (DEFAULT_VERDICT, StreamStats,
                                      VerdictConfig, regulator_draws,
                                      slot_accounting, slot_events)
from repro_torch.fleet.scenarios import ModState
from .admission import (AdmissionConfig, AdmissionState, DEFAULT_ADMISSION,
                        admission_admit, admission_update)
from .trace import (TraceSpec, TraceState, class_noise, class_table,
                    draw_arrivals)

# Latency-stamp defaults: a 1024-slot A-curve ring binned 8 slots wide.
LAT_HORIZON = 1024
LAT_BINS = 128


@dataclasses.dataclass(frozen=True)
class ServingCarry:
    """Everything a serving sim carries from slot to slot (the
    reference's eight fields)."""

    state: NetState
    stats: StreamStats
    drift: DriftStats
    mod: ModState
    tr: TraceState
    adm: AdmissionState
    lat: LatencyStats
    t: torch.Tensor               # [B] int32 slots advanced


@dataclasses.dataclass(frozen=True)
class ServingInputs:
    """The per-sim constants of one serving run of a batch."""

    pp: PaddedProblem
    lam: torch.Tensor             # [B] float32 offered rate over all classes
    eps_b: torch.Tensor           # [B] float32 regulator parameter
    ekind: torch.Tensor           # [B] int32 event-model code
    seed: torch.Tensor            # [B] int64 noise seed
    cdf: torch.Tensor             # [B, K, W] float64 class Poisson tables
    event_codes: tuple            # event codes present in the batch

    @property
    def codes(self) -> tuple:
        """The models present, a `GroupLaunch` key (the trace replaces the
        arrival models)."""
        return (self.event_codes,)


@dataclasses.dataclass(frozen=True)
class ServingRunner:
    """Chunked streaming serving of one (policy, trace) group.

    ``T`` is the horizon rounded up to whole chunks; ``window`` the
    trailing delivered-QPS window; ``verdict_*`` and ``admission_*`` the
    resolved windows and burn-ins of the verdict and the gate."""

    cfg: PolicyConfig
    trace: TraceSpec
    T: int
    chunk: int
    n_chunks: int
    window: int
    verdict_window: int
    verdict_burn_in: int
    verdict: VerdictConfig
    admission: AdmissionConfig
    admission_window: int
    admission_burn_in: int
    lat_horizon: int
    lat_bins: int

    @property
    def mark(self) -> int:
        return self.T - self.window

    @property
    def n_classes(self) -> int:
        return self.trace.n_classes

    def make_inputs(self, pp: PaddedProblem, lam, eps_b, ekind,
                    seed) -> ServingInputs:
        """Move one batch's per-sim constants to the problem's device and
        build its class tables (once per run)."""
        dev = pp.device
        lam = np.asarray(lam, np.float32).reshape(-1)
        ek = np.asarray(ekind, np.int32).reshape(-1)
        return ServingInputs(
            pp=pp, lam=torch.as_tensor(lam, device=dev),
            eps_b=torch.as_tensor(np.asarray(eps_b, np.float32).reshape(-1),
                                  device=dev),
            ekind=torch.as_tensor(ek, device=dev),
            seed=torch.as_tensor(np.asarray(seed, np.int64).reshape(-1),
                                 device=dev),
            cdf=class_table(self.trace, lam, dev),
            event_codes=tuple(sorted(set(ek.tolist()))))

    def init_carry(self, pp: PaddedProblem) -> ServingCarry:
        B, dev = pp.batch, pp.device
        return ServingCarry(
            init_state(pp), StreamStats.zero(B, dev), DriftStats.zero(B, dev),
            ModState.init(pp), TraceState.init(self.trace, B, dev),
            AdmissionState.zero(B, self.n_classes, dev),
            LatencyStats.zero(B, self.lat_horizon, self.lat_bins, dev),
            torch.zeros((B,), dtype=torch.int32, device=dev))

    # -- one slot ---------------------------------------------------------

    def slot(self, inp: ServingInputs, c: ServingCarry,
             class_arrivals: torch.Tensor | None = None,
             reg_draws: torch.Tensor | None = None) -> ServingCarry:
        """The carry after one slot of every sim (out of place)."""
        t = c.t
        if class_arrivals is None:
            u, u_phase = class_noise(self.trace, inp.seed, t)
            class_arrivals, tr = draw_arrivals(self.trace, inp.lam, t, c.tr,
                                               c.mod, u, u_phase, inp.cdf)
        else:
            tr = c.tr
        adm, admitted = admission_admit(c.adm, class_arrivals)
        es, cs, mod = slot_events(inp, t, c.mod)
        if self.cfg.use_regulator and reg_draws is None:
            reg_draws = regulator_draws(inp, t)
        state, m = slot_step(inp.pp.with_capacity_scales(es, cs), self.cfg,
                             c.state, admitted, reg_draws, inp.eps_b)
        stats, drift = slot_accounting(self, c.stats, c.drift, t, m, inp.lam)
        # The stamps compare the *admitted* cumulative curve (shed mass
        # never sojourns) against useful deliveries.
        lat = latency_update(c.lat, t, adm.admitted.sum(-1),
                             state.delivered_useful,
                             m["delivered_useful"]
                             - c.state.delivered_useful,
                             horizon=self.lat_horizon, n_bins=self.lat_bins)
        adm = admission_update(self.admission, adm, t, m["total_queue"],
                               state.delivered_useful, inp.lam, drift,
                               window=self.admission_window,
                               burn_in=self.admission_burn_in)
        return ServingCarry(state, stats, drift, mod, tr, adm, lat, t + 1)

    def advance(self, inp: ServingInputs, carry: ServingCarry,
                class_arrivals=None, reg_draws=None) -> None:
        """One slot, written into ``carry`` in place (no sim freezes)."""
        new = self.slot(inp, carry, class_arrivals, reg_draws)
        for o, n in zip(tree_leaves(carry), tree_leaves(new)):
            o.copy_(n)

    def chunk_step(self, inp: ServingInputs, carry: ServingCarry) -> None:
        """Advance every sim by one chunk of slots, in place."""
        for _ in range(self.chunk):
            self.advance(inp, carry)

    # -- results ----------------------------------------------------------

    def finalize(self, inp: ServingInputs,
                 c: ServingCarry) -> Dict[str, torch.Tensor]:
        """The per-sim metrics: [B] float32, the per-class ones [B, K]."""
        st, s, d, adm, lat = c.state, c.stats, c.drift, c.adm, c.lat
        tf = torch.clamp(c.t.to(torch.float32), min=1.0)
        admitted_total = adm.admitted.sum(-1)
        shed_total = adm.shed.sum(-1)
        offered_total = admitted_total + shed_total
        decided = d.verdict != VERDICT_UNDECIDED
        qtiles = latency_quantiles(lat.hist, (0.5, 0.99),
                                   horizon=self.lat_horizon,
                                   n_bins=self.lat_bins)
        q4_lo = (3 * self.T) // 4
        return {
            "offered": inp.lam,
            "eps_b": inp.eps_b,
            # Delivered QPS: trailing-window useful rate, the fleet metric.
            "delivered_qps": (st.delivered_useful - s.useful_at_mark)
            / self.window,
            "delivered_useful": st.delivered_useful,
            "admitted_total": admitted_total,
            "shed_total": shed_total,
            "admitted_rate": admitted_total / tf,
            "shed_frac": shed_total / torch.clamp(offered_total, min=1e-9),
            "p50_sojourn": qtiles[..., 0],
            "p99_sojourn": qtiles[..., 1],
            "mean_sojourn": latency_mean(lat),
            "mean_queue": s.sum_queue / tf,
            "mean_queue_tail": s.sum_queue_q4 / max(self.T - q4_lo, 1),
            "max_queue": s.max_queue,
            "gate_open_frac": adm.gate_slots / tf,
            "gate": adm.gate,
            "gate_flips": adm.flips.to(torch.float32),
            "verdict": d.verdict.to(torch.float32),
            "decided_at_slot": torch.where(
                decided, d.decided_at,
                torch.full_like(d.decided_at, self.T)).to(torch.float32),
            # Per-class fairness readout: each class's admitted share of
            # its own offered mass.
            "class_admitted": adm.admitted,
            "class_shed": adm.shed,
            "class_admit_frac": adm.admitted
            / torch.clamp(adm.admitted + adm.shed, min=1e-9),
        }

    def probe(self, c: ServingCarry) -> Dict[str, torch.Tensor]:
        """The small per-sim leaves a chunk-boundary stream record reads
        (cumulative values; the emitter differences consecutive probes)."""
        return {
            "t": c.t,
            "delivered_useful": c.state.delivered_useful,
            "admitted_total": c.adm.admitted.sum(-1),
            "shed_total": c.adm.shed.sum(-1),
            "gate": c.adm.gate,
            "gate_flips": c.adm.flips,
            "verdict": c.drift.verdict,
            "hist": c.lat.hist,
        }

    # -- the launcher's hooks (`fleet.engine.GroupLaunch`) ------------------

    def table_kinds(self, inp: ServingInputs) -> np.ndarray:
        """What a sim's class tables depend on besides its rate: nothing
        (the trace is the runner's)."""
        return np.zeros(inp.pp.batch, np.int32)

    def table(self, lam, kinds, device, width: int = 0) -> torch.Tensor:
        """The class tables of sims at offered rates ``lam``."""
        return class_table(self.trace, lam, device, width)

    def run(self, inp: ServingInputs,
            class_arrivals: torch.Tensor | None = None,
            reg_draws: torch.Tensor | None = None
            ) -> Dict[str, torch.Tensor]:
        """A whole run of the batch, eager.  ``class_arrivals`` [B, T, K]
        replaces the trace draws (the event models still run);
        ``reg_draws`` [B, T, NC] replaces the regulator's draws."""
        carry = self.init_carry(inp.pp)
        B = inp.pp.batch
        for name, x in (("class_arrivals", class_arrivals),
                        ("reg_draws", reg_draws)):
            if x is not None and (x.shape[0] != B or x.shape[1] != self.T):
                raise ValueError(f"explicit {name} must be [B={B}, "
                                 f"T={self.T}, ...], got {tuple(x.shape)}")
        if class_arrivals is None and reg_draws is None:
            for _ in range(self.n_chunks):
                self.chunk_step(inp, carry)
            return self.finalize(inp, carry)
        dev = inp.pp.device
        if class_arrivals is not None:
            class_arrivals = class_arrivals.to(device=dev,
                                               dtype=torch.float32)
        if reg_draws is not None:
            reg_draws = reg_draws.to(device=dev, dtype=torch.float32)
        for k in range(self.T):
            self.advance(inp, carry,
                         None if class_arrivals is None
                         else class_arrivals[:, k],
                         None if reg_draws is None else reg_draws[:, k])
        return self.finalize(inp, carry)


def make_serving_runner(cfg: PolicyConfig, trace: TraceSpec, T: int,
                        chunk: int = 512, window: int | None = None,
                        verdict: VerdictConfig | None = None,
                        admission: AdmissionConfig | None = None,
                        lat_horizon: int = LAT_HORIZON,
                        lat_bins: int = LAT_BINS) -> ServingRunner:
    """The memoized serving runner of one (policy, trace) group (the
    horizon is rounded up to whole chunks; ``runner.T`` is the effective
    slot count)."""
    return _make_serving_runner(cfg, trace, T, chunk, window,
                                verdict or DEFAULT_VERDICT,
                                admission or DEFAULT_ADMISSION,
                                lat_horizon, lat_bins)


@functools.lru_cache(maxsize=64)
def _make_serving_runner(cfg, trace, T, chunk, window, verdict, admission,
                         lat_horizon, lat_bins) -> ServingRunner:
    chunk = max(1, min(chunk, T))
    n_chunks = -(-T // chunk)
    T_eff = n_chunks * chunk
    win = T_eff // 2 if window is None else min(window, T_eff)
    win = max(win, 1)
    vwin = chunk if verdict.window <= 0 else max(1, min(verdict.window,
                                                        T_eff))
    vburn = 2 * vwin if verdict.burn_in <= 0 else verdict.burn_in
    awin = chunk if admission.window <= 0 else max(1, min(admission.window,
                                                          T_eff))
    aburn = 2 * awin if admission.burn_in <= 0 else admission.burn_in
    return ServingRunner(
        cfg=cfg, trace=trace, T=T_eff, chunk=chunk, n_chunks=n_chunks,
        window=win, verdict_window=vwin, verdict_burn_in=vburn,
        verdict=verdict, admission=admission, admission_window=awin,
        admission_burn_in=aburn, lat_horizon=lat_horizon, lat_bins=lat_bins)
