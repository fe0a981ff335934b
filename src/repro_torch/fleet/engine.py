"""Fleet engine: thousands of simulations as one batch on one device.

Port of `repro.fleet.engine`.  Jobs = (scenario x policy x rate x seed)
tuples.  The engine

  1. builds each job's topology once and pads all of them to fleet-wide
     maxima (`batching.PadDims`);
  2. groups jobs by the `PolicyConfig` axes that change control flow
     (`_policy_group_key`); everything else — topology, arrival and event
     model, rate, regulator parameter, seed — is per-sim data of one batch;
  3. runs each group as a Python loop of chunks of slots over batched
     [B, ...] state.  The batch axis takes the place of the reference's
     `vmap`, the chunk loop that of `lax.scan`, and one device that of the
     `shard_map` mesh (so there are no mesh-padding replicas).

The carry (queue state, online metric accumulators, drift statistics,
Markov modulation state, per-sim slot counter) is updated *in place* slot
by slot — the port's counterpart of the reference's donated carry — so the
fleet state exists once and horizons are memory-O(1).  With
``early_stop=True`` a sim whose streaming verdict has latched passes its
whole carry through unchanged (its slot counter included, so its noise
stream stays pinned), and a group stops once every sim has decided.

`run_fleet` advances a group through a `GroupLaunch` (`make_group_launch`,
the counterpart of the reference's compiled chunk programs): the run's
per-sim constants and its carry live in tensors allocated once per (policy
group x batch shape) and reused by every later run of that shape.  On CUDA
a chunk replays one captured CUDA graph of `GRAPH_SLOTS` slots, the chunk
step's few hundred launches per slot made by the host once, at capture;
on the CPU it runs the eager `StreamRunner.chunk_step`.  Between chunks
`make_sim_rewriter` restarts or parks single sims in place (the capacity
atlas moves each lane to its next probe that way).  The same launcher
drives the serving runner (`repro_torch.serving.scheduler`).  With a
stream on, the carry's probe goes out between chunks through the
telemetry plane (`repro_torch.obs.emitter`), never inside the graph.

Randomness comes from the counter-based stream of
`repro_torch.sim.workload`, keyed by (job seed, the sim's own slot, draw
site, element), so a job's metrics do not depend on the batch it runs in.
`StreamRunner.run` also takes an explicit arrival trace and regulator draws
(the noise seam the parity tests feed with JAX's noise).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.policies import PolicyConfig, slot_step
from repro_torch.core.queues import (DriftStats, NetState, VERDICT_NAMES,
                                     VERDICT_STABLE, VERDICT_UNDECIDED,
                                     VERDICT_UNSTABLE, drift_verdict_update,
                                     init_state)
from repro_torch.device import resolve_device, tree_leaves
from repro_torch.kernels.bp_slot.ref import kahan_add
from repro_torch.obs import spans
from repro_torch.obs.emitter import ChunkEmitter, open_sink
from repro_torch.sim import workload
from .batching import PadDims, PaddedProblem, from_leaves, pad_leaves
from .capture import GRAPH_SLOTS, CapturedSlots, launch_device
from .scenarios import (ARRIVAL_MODEL_ORDER, ARRIVAL_MODELS,
                        COMP_NOISE_EVENTS, EVENT_MODEL_ORDER, EVENT_MODELS,
                        LINK_NOISE_EVENTS, ModState, arrival_code,
                        arrival_rates, event_code, get_scenario)


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One simulation of the sweep grid."""

    scenario: str
    policy: str = "pi3"
    lam: float = 1.0
    seed: int = 0                 # simulation randomness
    topo_seed: int = 0            # topology-generator randomness
    eps_b: float = 0.01           # regulator parameter, per-sim data
    pairing: str = "fifo"
    threshold: float = 0.0
    fixed_node: int = 0

    def policy_config(self) -> PolicyConfig:
        return PolicyConfig(
            name=self.policy, eps_b=self.eps_b, pairing=self.pairing,
            threshold=self.threshold, fixed_node=self.fixed_node,
            wireless=get_scenario(self.scenario).wireless)


@dataclasses.dataclass(frozen=True)
class VerdictConfig:
    """Streaming stability-verdict parameters (as in the reference)."""

    window: int = 0        # verdict window in slots; <= 0 -> the chunk size
    burn_in: int = 0       # slots before evidence counts; <= 0 -> 2 windows
    k_stable: int = 3      # consecutive stable windows that latch STABLE
    k_unstable: int = 3    # consecutive unstable windows that latch UNSTABLE
    drift_tol: float = 0.02   # per-slot drift threshold, x max(lam, 1)
    gap_tol: float = 0.05     # delivered-vs-offered gap threshold, x max(lam, 1)
    freeze: bool = False      # freeze decided sims (early-stop semantics)


DEFAULT_VERDICT = VerdictConfig()


def resolve_verdict(verdict: VerdictConfig | None,
                    early_stop: bool) -> VerdictConfig:
    """The verdict config `run_fleet` runs: the default when none is given,
    with ``freeze`` forced on when early stopping is requested."""
    v = verdict or DEFAULT_VERDICT
    if early_stop and not v.freeze:
        v = dataclasses.replace(v, freeze=True)
    return v


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Online accumulators of every sim, each field [B] float32; the
    backlog sums are Kahan-compensated (``c_*``)."""

    sum_queue: torch.Tensor
    c_queue: torch.Tensor
    sum_queue_q3: torch.Tensor    # backlog sum over slots [T/2, 3T/4)
    c_q3: torch.Tensor
    sum_queue_q4: torch.Tensor    # backlog sum over slots [3T/4, T)
    c_q4: torch.Tensor
    max_queue: torch.Tensor
    useful_at_mark: torch.Tensor  # cumulative useful count at window start

    @staticmethod
    def zero(B: int, device) -> "StreamStats":
        return StreamStats(*(torch.zeros((B,), dtype=torch.float32,
                                         device=device) for _ in range(8)))


@dataclasses.dataclass(frozen=True)
class Carry:
    """Everything a sim carries from slot to slot."""

    state: NetState
    stats: StreamStats
    drift: DriftStats
    mod: ModState
    t: torch.Tensor               # [B] int32 slots advanced


@dataclasses.dataclass(frozen=True)
class RunInputs:
    """The per-sim constants of one run of a batch."""

    pp: PaddedProblem
    lam: torch.Tensor             # [B] float32 offered rate
    eps_b: torch.Tensor           # [B] float32 regulator parameter
    akind: torch.Tensor           # [B] int32 arrival-model code
    ekind: torch.Tensor           # [B] int32 event-model code
    seed: torch.Tensor            # [B] int64 noise seed
    cdf: torch.Tensor             # [B, K] float64 Poisson tables
    arrival_codes: Tuple[int, ...]  # codes present in the batch
    event_codes: Tuple[int, ...]

    @property
    def codes(self) -> tuple:
        """The model codes present: with the batch shape, they key the
        batch's `GroupLaunch` (each present model is a branch of its
        slot)."""
        return (self.arrival_codes, self.event_codes)


def make_inputs(pp: PaddedProblem, lam, eps_b, akind, ekind,
                seed) -> RunInputs:
    """Move one batch's per-sim constants to the problem's device and
    build its Poisson tables (once per run)."""
    dev = pp.device
    lam = np.asarray(lam, np.float32).reshape(-1)
    ak = np.asarray(akind, np.int32).reshape(-1)
    ek = np.asarray(ekind, np.int32).reshape(-1)
    return RunInputs(
        pp=pp,
        lam=torch.as_tensor(lam, device=dev),
        eps_b=torch.as_tensor(np.asarray(eps_b, np.float32).reshape(-1),
                              device=dev),
        akind=torch.as_tensor(ak, device=dev),
        ekind=torch.as_tensor(ek, device=dev),
        seed=torch.as_tensor(np.asarray(seed, np.int64).reshape(-1),
                             device=dev),
        cdf=workload.poisson_table(arrival_rates(lam, ak), device=dev),
        arrival_codes=tuple(sorted(set(ak.tolist()))),
        event_codes=tuple(sorted(set(ek.tolist()))))


def _select(codes, kind, values):
    """Per-sim selection among the models present: ``values[i]`` is the
    result of model ``codes[i]``; sims take the one of their own code."""
    out = values[0]
    for code, v in zip(codes[1:], values[1:]):
        pick = (kind == code).view(-1, *([1] * (v.dim() - 1)))
        out = torch.where(pick, v, out)
    return out


def slot_events(inp, t, mod):
    """One slot of every sim's capacity event model: (edge_scale [B, E],
    comp_scale [B, NC], mod').  ``inp`` is any run's inputs with ``pp``,
    ``seed``, ``ekind`` and ``event_codes``."""
    pp = inp.pp
    names = [EVENT_MODEL_ORDER[c] for c in inp.event_codes]
    u_link = u_comp = None
    if set(names) & set(LINK_NOISE_EVENTS):
        u_link = workload.uniform(inp.seed, t, workload.SITE_EVENT_LINK,
                                  pp.n_edges)
    if set(names) & set(COMP_NOISE_EVENTS):
        u_comp = workload.uniform(inp.seed, t, workload.SITE_EVENT_COMP,
                                  pp.n_comp)
    outs = [EVENT_MODELS[n](pp, t, u_link, u_comp, mod) for n in names]
    codes, kind = inp.event_codes, inp.ekind
    es = _select(codes, kind, [o[0] for o in outs])
    cs = _select(codes, kind, [o[1] for o in outs])
    mod = mod.replace(link=_select(codes, kind, [o[2].link for o in outs]),
                      comp=_select(codes, kind, [o[2].comp for o in outs]))
    return es, cs, mod


def regulator_draws(inp, t) -> torch.Tensor:
    """The regulator's Bernoulli(eps_b) draws of one slot, [B, NC]."""
    return workload.regulator_bits(inp.seed, t, inp.eps_b, inp.pp.n_comp)


def slot_accounting(runner, s: StreamStats, d: DriftStats, t, m: Dict,
                    lam: torch.Tensor):
    """One slot of the online metric accumulators and the streaming
    verdict, from the slot step's metrics ``m``: (stats', drift').
    ``runner`` gives the horizon ``T``, the rate window's ``mark`` and the
    verdict's parameters."""
    tq = m["total_queue"]
    q3_lo, q4_lo = runner.T // 2, (3 * runner.T) // 4
    sq, cq = kahan_add(s.sum_queue, s.c_queue, tq)
    s3, c3 = kahan_add(s.sum_queue_q3, s.c_q3,
                       tq * ((t >= q3_lo) & (t < q4_lo)))
    s4, c4 = kahan_add(s.sum_queue_q4, s.c_q4, tq * (t >= q4_lo))
    stats = StreamStats(
        sum_queue=sq, c_queue=cq, sum_queue_q3=s3, c_q3=c3,
        sum_queue_q4=s4, c_q4=c4,
        max_queue=torch.maximum(s.max_queue, tq),
        useful_at_mark=torch.where(t == runner.mark - 1,
                                   m["delivered_useful"], s.useful_at_mark))
    v = runner.verdict
    drift = drift_verdict_update(
        d, t, tq, m["delivered_useful"], lam,
        window=runner.verdict_window, burn_in=runner.verdict_burn_in,
        k_stable=v.k_stable, k_unstable=v.k_unstable,
        drift_tol=v.drift_tol, gap_tol=v.gap_tol)
    return stats, drift


@dataclasses.dataclass(frozen=True)
class StreamRunner:
    """Chunked streaming simulation of one policy group.

    ``T`` is the horizon rounded up to whole chunks; ``window`` the
    trailing useful-rate window; ``verdict_window``/``verdict_burn_in`` the
    streaming verdict's window and burn-in."""

    cfg: PolicyConfig
    T: int
    chunk: int
    n_chunks: int
    window: int
    verdict_window: int
    verdict_burn_in: int
    verdict: VerdictConfig

    @property
    def mark(self) -> int:
        return self.T - self.window

    def init_carry(self, pp: PaddedProblem) -> Carry:
        B, dev = pp.batch, pp.device
        return Carry(init_state(pp), StreamStats.zero(B, dev),
                     DriftStats.zero(B, dev), ModState.init(pp),
                     torch.zeros((B,), dtype=torch.int32, device=dev))

    # -- noise ------------------------------------------------------------

    def _arrivals(self, inp: RunInputs, t, mod):
        names = [ARRIVAL_MODEL_ORDER[c] for c in inp.arrival_codes]
        u = u_phase = None
        if set(names) - {"constant"}:
            u = workload.uniform64(inp.seed, t, workload.SITE_ARRIVAL, 1)[:, 0]
        if "markov_onoff" in names:
            u_phase = workload.uniform(inp.seed, t,
                                       workload.SITE_ARRIVAL_PHASE, 1)[:, 0]
        outs = [ARRIVAL_MODELS[n](inp.lam, u, u_phase, inp.cdf, mod)
                for n in names]
        arr = _select(inp.arrival_codes, inp.akind, [o[0] for o in outs])
        burst = _select(inp.arrival_codes, inp.akind,
                        [o[1].burst for o in outs])
        return arr, mod.replace(burst=burst)

    # -- one slot ---------------------------------------------------------

    def slot(self, inp: RunInputs, c: Carry, arrivals=None,
             reg_draws=None) -> Carry:
        """The carry after one slot of every sim (out of place)."""
        t = c.t
        if arrivals is None:
            arrivals, mod = self._arrivals(inp, t, c.mod)
        else:
            mod = c.mod
        es, cs, mod = slot_events(inp, t, mod)
        if self.cfg.use_regulator and reg_draws is None:
            reg_draws = regulator_draws(inp, t)
        state, m = slot_step(inp.pp.with_capacity_scales(es, cs), self.cfg,
                             c.state, arrivals, reg_draws, inp.eps_b)
        stats, drift = slot_accounting(self, c.stats, c.drift, t, m, inp.lam)
        return Carry(state, stats, drift, mod, t + 1)

    def advance(self, inp: RunInputs, carry: Carry, arrivals=None,
                reg_draws=None) -> None:
        """One slot, written into ``carry`` in place.  Under ``freeze`` a
        sim whose verdict latched before this slot keeps its whole carry
        (where(False, old, new) is exactly new, so undecided sims match a
        freeze-free run bit for bit)."""
        new = self.slot(inp, carry, arrivals, reg_draws)
        if self.verdict.freeze:
            frozen = carry.drift.verdict != VERDICT_UNDECIDED
            for o, n in zip(tree_leaves(carry), tree_leaves(new)):
                keep = frozen.view(-1, *([1] * (o.dim() - 1)))
                o.copy_(torch.where(keep, o, n))
        else:
            for o, n in zip(tree_leaves(carry), tree_leaves(new)):
                o.copy_(n)

    def chunk_step(self, inp: RunInputs, carry: Carry) -> None:
        """Advance every sim by one chunk of slots, in place."""
        for _ in range(self.chunk):
            self.advance(inp, carry)

    # -- results ----------------------------------------------------------

    def finalize(self, inp: RunInputs, c: Carry) -> Dict[str, torch.Tensor]:
        """The per-sim metrics, each [B] float32."""
        st, s, d = c.state, c.stats, c.drift
        T = self.T
        q3_lo, q4_lo = T // 2, (3 * T) // 4
        mean_q3 = s.sum_queue_q3 / max(q4_lo - q3_lo, 1)
        mean_q4 = s.sum_queue_q4 / max(T - q4_lo, 1)
        decided = d.verdict != VERDICT_UNDECIDED
        decided_at = torch.where(decided, d.decided_at,
                                 torch.full_like(d.decided_at, T)
                                 ).to(torch.float32)
        stable = mean_q4 <= 1.25 * mean_q3 + 5.0
        useful_rate = (st.delivered_useful - s.useful_at_mark) / self.window
        mean_queue = s.sum_queue / torch.clamp(c.t.to(torch.float32), min=1.0)
        slots_saved = torch.zeros_like(mean_queue)
        if self.verdict.freeze:
            useful_rate = torch.where(decided, d.last_rate, useful_rate)
            stable = torch.where(decided, d.verdict == VERDICT_STABLE, stable)
            slots_saved = torch.where(decided, T - decided_at, slots_saved)
        return {
            "offered": inp.lam,
            "eps_b": inp.eps_b,
            "useful_rate": useful_rate,
            "delivered": st.delivered,
            "delivered_useful": st.delivered_useful,
            "delivered_dummy": st.delivered - st.delivered_useful,
            "mean_queue": mean_queue,
            "mean_queue_mid": mean_q3,
            "mean_queue_tail": mean_q4,
            "max_queue": s.max_queue,
            "stable": stable.to(torch.float32),
            "verdict": d.verdict.to(torch.float32),
            "decided_at_slot": decided_at,
            "slots_saved": slots_saved,
        }

    def probe(self, c: Carry) -> Dict[str, torch.Tensor]:
        """The carry's leaves a chunk-boundary stream record reads (port of
        the reference's ``probe``): views of the carry, no computation, so
        tapping them changes nothing the chunk step runs."""
        return {
            "t": c.t,
            "delivered_useful": c.state.delivered_useful,
            "sum_queue": c.stats.sum_queue,
            "max_queue": c.stats.max_queue,
            "last_rate": c.drift.last_rate,
            "last_drift": c.drift.last_drift,
            "verdict": c.drift.verdict,
            "decided_at": c.drift.decided_at,
        }

    # -- the launcher's hooks (`GroupLaunch`) -----------------------------

    def table_kinds(self, inp: RunInputs) -> np.ndarray:
        """Each sim's arrival-model code: what its Poisson row depends on
        besides its rate."""
        return _to_host(inp.akind)

    def table(self, lam, kinds, device, width: int = 0) -> torch.Tensor:
        """The Poisson tables of sims at rates ``lam`` with arrival models
        ``kinds``, at least ``width`` columns wide."""
        return workload.poisson_table(arrival_rates(lam, kinds),
                                      device=device, width=width)

    def run(self, inp: RunInputs, arrivals: torch.Tensor | None = None,
            reg_draws: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
        """A whole run of the batch.  ``arrivals`` [B, T] replaces the
        arrival models (the event models still run); ``reg_draws``
        [B, T, NC] replaces the regulator's Bernoulli draws."""
        carry = self.init_carry(inp.pp)
        for name, x in (("arrivals", arrivals), ("reg_draws", reg_draws)):
            if x is not None and (x.shape[0] != inp.pp.batch
                                  or x.shape[1] != self.T):
                raise ValueError(f"explicit {name} must be [B={inp.pp.batch},"
                                 f" T={self.T}, ...], got {tuple(x.shape)}")
        if arrivals is None and reg_draws is None:
            for _ in range(self.n_chunks):
                self.chunk_step(inp, carry)
        else:
            dev = inp.pp.device
            if arrivals is not None:
                arrivals = arrivals.to(device=dev, dtype=torch.float32)
            if reg_draws is not None:
                reg_draws = reg_draws.to(device=dev, dtype=torch.float32)
            for k in range(self.T):
                self.advance(inp, carry,
                             None if arrivals is None else arrivals[:, k],
                             None if reg_draws is None else reg_draws[:, k])
        return self.finalize(inp, carry)


def make_stream_runner(cfg: PolicyConfig, T: int, chunk: int = 1024,
                       window: int | None = None,
                       verdict: VerdictConfig | None = None) -> StreamRunner:
    """The chunked runner of one policy group (the horizon is rounded up to
    whole chunks; ``runner.T`` is the effective slot count)."""
    vcfg = verdict or DEFAULT_VERDICT
    chunk = max(1, min(chunk, T))
    n_chunks = -(-T // chunk)
    T_eff = n_chunks * chunk
    win = T_eff // 2 if window is None else min(window, T_eff)
    win = max(win, 1)
    vwin = chunk if vcfg.window <= 0 else max(1, min(vcfg.window, T_eff))
    vburn = 2 * vwin if vcfg.burn_in <= 0 else vcfg.burn_in
    return StreamRunner(cfg=cfg, T=T_eff, chunk=chunk, n_chunks=n_chunks,
                        window=win, verdict_window=vwin,
                        verdict_burn_in=vburn, verdict=vcfg)


def stream_simulate(problem: ComputeProblem, cfg: PolicyConfig, lam: float,
                    T: int, chunk: int = 1024, window: int | None = None,
                    seed: int = 0, arrivals: torch.Tensor | None = None,
                    arrival: str = "poisson", events: str = "static",
                    dims: PadDims | None = None,
                    reg_draws: torch.Tensor | None = None,
                    device=None) -> Dict[str, float]:
    """Single-problem streaming simulation: a batch of one.

    ``arrivals`` [T] and ``reg_draws`` [T, NC] are the optional explicit
    noise (see `StreamRunner.run`)."""
    dev = resolve_device(device)
    dims = dims or PadDims.of([problem])
    pp = from_leaves([pad_leaves(problem, dims)], dims.n_nodes, dims.n_comp,
                     dev)
    run = make_stream_runner(cfg, T, chunk=chunk, window=window)
    inp = make_inputs(pp, [lam], [cfg.eps_b], [arrival_code(arrival)],
                      [event_code(events)], [seed])
    out = run.run(inp,
                  None if arrivals is None else torch.as_tensor(arrivals)[None],
                  None if reg_draws is None else
                  torch.as_tensor(reg_draws)[None])
    return {k: float(v[0]) for k, v in out.items()}


def _write(dst, src) -> None:
    """Copy every tensor of tree ``src`` into the same leaf of ``dst``."""
    for d, s_ in zip(tree_leaves(dst), tree_leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s_)


def _clone(tree):
    """A copy of a tree of frozen dataclasses with every tensor cloned."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _widen(cdf: torch.Tensor, width: int) -> torch.Tensor:
    """``cdf`` with 1.0 in new trailing columns up to ``width``: rows are
    1.0 beyond their own width, so no draw changes."""
    if cdf.shape[-1] >= width:
        return cdf
    out = torch.ones((*cdf.shape[:-1], width), dtype=cdf.dtype,
                     device=cdf.device)
    out[..., :cdf.shape[-1]] = cdf
    return out


class GroupLaunch(CapturedSlots):
    """The chunk step of one group at one batch shape, on tensors allocated
    once: the port's counterpart of the reference's compiled chunk-step
    programs (`repro.fleet.engine.make_group_launch`).

    It drives any runner with ``init_carry``, ``advance``, ``chunk_step``
    and the table hooks ``table_kinds``/``table`` (`StreamRunner`, and the
    serving runner, `repro_torch.serving.scheduler.ServingRunner`), on the
    inputs that runner builds: a frozen dataclass with ``pp``, ``lam``,
    ``seed``, a Poisson table ``cdf`` whose last axis is its columns, and
    ``codes``, the models present.  ``inp`` and ``carry`` are static:
    `start` copies a run's per-sim constants into them and resets the
    carry, `step` advances every sim by one chunk in place, `rewrite` (see
    `make_sim_rewriter`) restarts or parks single sims between chunks.
    Nothing rebinds them but a wider Poisson table (below), which drops
    the graph, so a graph captured over them stays valid.

    On CUDA the first `step` advances `block` slots eagerly (which loads
    every kernel a slot runs), then captures those same `block` slots into
    one `torch.cuda.CUDAGraph` and replays it for the rest of the chunk and
    for every later chunk; a failed capture raises.  The Poisson table is
    sized once, for the largest rate `start` is told the lanes may probe;
    a rate that needs a wider table reallocates it and captures again.
    ``n_compiles`` counts the captures (on the CPU, where `step` runs the
    runner's eager ``chunk_step``, it is 1: the launcher made); the
    capture and its counts (``replays``, ``captured``) are
    `CapturedSlots`'."""

    def __init__(self, runner, batch: int, dims, device: torch.device,
                 *codes):
        super().__init__(math.gcd(runner.chunk, GRAPH_SLOTS))
        self.runner = runner
        self.batch = batch
        self.dims = dims
        self.device = launch_device(device)
        self.codes = codes
        self.inp = None
        self.carry = None
        self._kinds = np.zeros(batch, np.int32)

    @property
    def n_compiles(self) -> int:
        return self.n_captures if self.device.type == "cuda" else 1

    def _table(self, lam, kinds, width: int = 0) -> torch.Tensor:
        return self.runner.table(lam, kinds, self.device, width)

    def _grow(self, width: int) -> None:
        """A wider Poisson table (1.0 in the new columns); the graph
        captured over the old one is dropped."""
        self.inp = dataclasses.replace(self.inp,
                                       cdf=_widen(self.inp.cdf, width))
        self.graph = None

    def start(self, inp, max_rate: float = 0.0) -> None:
        """Load a run's per-sim constants and reset every sim's carry.
        ``max_rate`` is the largest offered rate a later `rewrite` may give
        a lane; the Poisson table is sized for it."""
        pp = inp.pp
        shape = (pp.batch, pp.n_nodes, pp.n_edges, pp.n_comp)
        want = (self.batch, self.dims.n_nodes, self.dims.n_edges,
                self.dims.n_comp)
        if shape != want or inp.codes != self.codes or \
                pp.device != self.device:
            raise ValueError(f"GroupLaunch for {want} {self.codes} on "
                             f"{self.device} got {shape} {inp.codes} on "
                             f"{pp.device}")
        self._kinds = self.runner.table_kinds(inp)
        lam = _to_host(inp.lam)
        width = inp.cdf.shape[-1]
        if lam.size and np.float32(max_rate) > lam.min():
            # A later rewrite may offer more than the run's own rates.
            width = max(width, self._table(
                np.maximum(lam, np.float32(max_rate)), self._kinds).shape[-1])
        if self.inp is None:
            self.inp = _clone(dataclasses.replace(
                inp, cdf=_widen(inp.cdf, width)))
            self.carry = self.runner.init_carry(self.inp.pp)
            return
        if width > self.inp.cdf.shape[-1]:
            self._grow(width)
        _write(self.inp, dataclasses.replace(
            inp, cdf=_widen(inp.cdf, self.inp.cdf.shape[-1])))
        _write(self.carry, self.runner.init_carry(self.inp.pp))

    def _block(self) -> None:
        for _ in range(self.block):
            self.runner.advance(self.inp, self.carry)

    def step(self) -> None:
        """Advance every sim by one chunk of slots, in place."""
        if self.device.type != "cuda":
            self.runner.chunk_step(self.inp, self.carry)
            return
        replays = self.runner.chunk // self.block
        if self.graph is None:
            self._block()
            self.capture(self._block)
            replays -= 1
        self.replay(replays)

    @spans.traced("fleet.rewrite")
    def rewrite(self, reset, park, lam=None, seed=None) -> None:
        """The per-sim rewrite between chunks (`make_sim_rewriter`)."""
        reset = np.asarray(reset, bool).reshape(-1)
        park = np.asarray(park, bool).reshape(-1)
        if reset.shape != (self.batch,) or park.shape != (self.batch,):
            raise ValueError(f"reset and park must be [{self.batch}] masks")
        lanes = np.flatnonzero(reset)
        if lanes.size:
            lam = np.asarray(lam, np.float32).reshape(-1)[lanes]
            seed = np.asarray(seed, np.int64).reshape(-1)[lanes]
            rows = self._table(lam, self._kinds[lanes],
                               self.inp.cdf.shape[-1])
            if rows.shape[-1] > self.inp.cdf.shape[-1]:
                self._grow(rows.shape[-1])
            idx = torch.as_tensor(lanes, device=self.device)
            mask = torch.as_tensor(reset, device=self.device)
            fresh = self.runner.init_carry(self.inp.pp)
            for o, f in zip(tree_leaves(self.carry), tree_leaves(fresh)):
                take = mask.view(-1, *([1] * (o.dim() - 1)))
                o.copy_(torch.where(take, f, o))
            self.inp.lam.index_copy_(0, idx, torch.as_tensor(
                lam, device=self.device))
            self.inp.seed.index_copy_(0, idx, torch.as_tensor(
                seed, device=self.device))
            self.inp.cdf.index_copy_(0, idx, rows)
        if park.any():
            v = self.carry.drift.verdict
            v.copy_(torch.where(torch.as_tensor(park, device=self.device),
                                VERDICT_UNSTABLE, v))


@functools.lru_cache(maxsize=16)
def make_group_launch(runner, batch: int, dims, device: torch.device,
                      *codes) -> GroupLaunch:
    """The `GroupLaunch` of one group's runner at one batch shape
    (``batch`` sims padded to ``dims``, the models ``codes`` present: for
    the fleet the arrival and the event codes), memoized like the
    reference's: every later run of the same shape, a frontier's next
    probe say, reuses its tensors and its captured graph."""
    return GroupLaunch(runner, batch, dims, device, *codes)


def launch_for(runner, inp) -> GroupLaunch:
    """`make_group_launch` for the shape of ``inp``."""
    pp = inp.pp
    return make_group_launch(runner, pp.batch,
                             PadDims(pp.n_nodes, pp.n_edges, pp.n_comp),
                             pp.device, *inp.codes)


def make_sim_rewriter(launch: GroupLaunch):
    """The per-sim carry rewrite of the capacity atlas, on ``launch``'s
    static tensors: ``rewrite(reset, park, lam=None, seed=None)``, with
    [B] bool masks, between chunks (port of the reference's
    `make_sim_rewriter`).

      * ``reset``: the lane starts its next probe.  Its carry becomes a
        fresh `init_carry` (t = 0 included, so its noise stream restarts
        under the new seed), and its offered rate, noise seed and Poisson
        row become ``lam[lane]``, ``seed[lane]`` and that rate's row.
      * ``park``: the lane's search is over.  Its verdict leaf becomes
        UNSTABLE, so under ``freeze`` its carry stays fixed from then on.

    Everything is written in place (``copy_``, ``index_copy_``) into the
    tensors a captured graph reads, and a lane in neither mask keeps every
    bit (``where(False, fresh, old)`` is ``old``)."""
    return launch.rewrite


@dataclasses.dataclass
class FleetResult:
    jobs: List[FleetJob]
    metrics: List[Dict[str, float]]     # one dict per job, same order
    n_programs: int                     # policy groups (one batch each)
    n_sims: int
    dims: PadDims
    T: int
    window: int
    slots_saved: int = 0          # sum of per-sim frozen slots (early stop)
    launch_slots_saved: int = 0   # sim-slots of chunks never run once a
                                  # whole group had decided
    slot_steps: int = 0           # batched slot steps this call ran, over
                                  # all groups
    device: str = ""
    n_step_compiles: int = 0      # chunk programs of the groups' launchers:
                                  # graph captures on CUDA, launchers on the
                                  # CPU (cumulative per launcher)
    stream_records: List[dict] = dataclasses.field(default_factory=list)
    resumed_from: int | None = None   # checkpoint step this run restored
                                      # (`runtime.resilience`); None = fresh
    degraded: Dict[int, str] = dataclasses.field(default_factory=dict)
                                  # job index -> why its lane was parked
    recovery_plan: object | None = None   # runtime.fault.RecoveryPlan
    n_fault_retries: int = 0      # injected launch failures retried

    def column(self, name: str) -> np.ndarray:
        return np.array([m[name] for m in self.metrics])

    def verdicts(self) -> List[str]:
        """Per-job streaming verdicts as names."""
        return [VERDICT_NAMES[int(m["verdict"])] for m in self.metrics]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: a blocking read of the run loop, where the host
    waits on the device (span ``fleet.readback``; its bytes counted)."""
    with spans.span("fleet.readback"):
        out = t.cpu().numpy()
    spans.count("host.readback_bytes", out.nbytes)
    return out


def _policy_group_key(job: FleetJob):
    """The axes that change control flow, hence one batch each."""
    cfg = job.policy_config()
    return (cfg.use_regulator, cfg.load_balance, cfg.thresholded,
            cfg.pairing, cfg.threshold, cfg.fixed_node, cfg.wireless)


@spans.traced("fleet.run")
def run_fleet(jobs: Sequence[FleetJob], T: int, chunk: int = 1024,
              window: int | None = None, device=None,
              dims: PadDims | None = None,
              early_stop: bool = False,
              verdict: VerdictConfig | None = None,
              max_rate: float = 0.0,
              stream: bool = False,
              stream_log: Callable[[dict], None] | None = None,
              stream_path: str | None = None,
              resilience=None) -> FleetResult:
    """Run the whole sweep, one batch per policy group, on ``device``
    (CUDA unless the caller asks for the CPU).

    Each group runs through its `GroupLaunch` (on CUDA, replays of one
    captured chunk).  ``early_stop=True`` freezes decided sims inside their
    batch and stops a group as soon as every sim in it has decided (the
    verdict leaf is read back between chunks).  ``max_rate`` sizes the
    Poisson tables for offered rates up to it, so that later calls of the
    same shape with rates up to it replay the same graph (the frontier
    passes its bracket's top); no metric depends on it.

    ``stream=True`` (implied by ``stream_log``/``stream_path``) turns on
    the telemetry plane (`repro_torch.obs.emitter`): after every chunk the
    carry's probe leaves are snapshot and differenced into one fleet
    record per chunk, off the chunk step (the captured graph is the same
    and every metric bit-identical).  Records land in
    ``FleetResult.stream_records``; ``stream_path`` appends them live as
    JSONL, and ``stream_log`` is called per record on the emitter's worker
    thread.

    ``resilience`` (a `runtime.resilience.ResilienceConfig`) makes the run
    preemption-safe: the carry and the host cursor are snapshot at chunk
    boundaries (copied to host memory before the next chunk overwrites the
    carry), a killed run resumes bit-exact from the newest intact
    checkpoint (the carry written into the launch's tensors in place, so
    a same-process resume captures nothing new; the stream file appended
    to, deduplicated, with one ``resume`` record at the seam), injected
    launch failures retry with bounded backoff, and a host dropout parks
    its lanes through `make_sim_rewriter`, surfaced in
    ``FleetResult.degraded``/``recovery_plan`` rather than aborting."""
    from repro_torch.runtime.resilience import RunProgress, maybe_resilient
    dev = resolve_device(device)
    jobs = list(jobs)
    vcfg = resolve_verdict(verdict, early_stop)
    with spans.span("fleet.build"):
        problem_of: Dict[tuple, ComputeProblem] = {}
        for job in jobs:
            k = (job.scenario, job.topo_seed)
            if k not in problem_of:
                problem_of[k] = get_scenario(job.scenario).build(
                    job.topo_seed)
        dims = dims or PadDims.of(list(problem_of.values()))
        leaves_of = {k: pad_leaves(p, dims) for k, p in problem_of.items()}

    groups: Dict[tuple, List[int]] = {}
    for i, job in enumerate(jobs):
        groups.setdefault(_policy_group_key(job), []).append(i)

    rt = maybe_resilient(resilience, "fleet", jobs=tuple(jobs), T=T,
                         chunk=chunk, window=window, verdict=vcfg,
                         early_stop=early_stop, dims=dims, ndev=1)
    resumed = rt.resumed if rt is not None else None
    prog = RunProgress.start(len(jobs), resumed)
    sink = open_sink(stream, stream_log, stream_path,
                     append=resumed is not None)
    eff_T = eff_win = 0
    slot_steps = n_compiles = 0
    try:
        for g, idxs in enumerate(groups.values()):
            if resumed is not None and g < resumed["group"]:
                # Finished before the kill: its metrics were restored.
                runner = make_stream_runner(
                    jobs[idxs[0]].policy_config(), T, chunk=chunk,
                    window=window, verdict=vcfg)
                eff_T, eff_win = runner.T, runner.window
                continue
            ran, launched, runner, launch = _run_fleet_group(
                g, idxs, jobs, T, chunk, window, vcfg, dims, leaves_of, dev,
                early_stop, max_rate, sink, rt, prog)
            eff_T, eff_win = runner.T, runner.window
            slot_steps += ran * runner.chunk
            prog.launch_saved += (len(idxs) * (runner.n_chunks - launched)
                                  * runner.chunk)
            n_compiles += launch.n_compiles
            with spans.span("fleet.finalize"):
                out = runner.finalize(launch.inp, launch.carry)
                host = _to_host(torch.stack(list(out.values())))  # one copy
                for j, i in enumerate(idxs):
                    prog.metrics[i] = {k: float(v[j])
                                       for k, v in zip(out, host)}
            if rt is not None:
                # Group-boundary marker: a kill between groups resumes at
                # g + 1 with the finished metrics, never re-running g.
                rt.snapshot(prog.glaunch, (), prog.extra(g + 1, 0))
    finally:
        if sink is not None:
            sink.close()
        if rt is not None:
            rt.wait()
    metrics = prog.metrics
    return FleetResult(jobs=jobs, metrics=metrics, n_programs=len(groups),
                       n_sims=len(jobs), dims=dims, T=eff_T, window=eff_win,
                       slots_saved=int(sum(m["slots_saved"]
                                           for m in metrics)),
                       launch_slots_saved=prog.launch_saved,
                       slot_steps=slot_steps, device=str(dev),
                       n_step_compiles=n_compiles,
                       stream_records=(sink.records if sink is not None
                                       else []),
                       resumed_from=(resumed["ckpt_step"]
                                     if resumed is not None else None),
                       degraded=prog.degraded, recovery_plan=prog.recovery,
                       n_fault_retries=rt.n_retries if rt is not None else 0)


def _run_fleet_group(g: int, idxs: List[int], jobs, T, chunk, window, vcfg,
                     dims, leaves_of, dev, early_stop, max_rate, sink, rt,
                     prog):
    """Run one policy group of `run_fleet` to its end (or its early stop),
    resuming it from ``rt``'s checkpoint when the run resumes in it:
    (chunks this call ran, chunks launched in all, runner, its
    `GroupLaunch`)."""
    from repro_torch.runtime.resilience import resume_group
    group = [jobs[i] for i in idxs]
    cfg = group[0].policy_config()
    with spans.span("fleet.build"):
        runner = make_stream_runner(cfg, T, chunk=chunk, window=window,
                                    verdict=vcfg)
        pp = from_leaves([leaves_of[(j.scenario, j.topo_seed)]
                          for j in group], dims.n_nodes, dims.n_comp, dev)
        inp = make_inputs(
            pp, [j.lam for j in group], [j.eps_b for j in group],
            [arrival_code(get_scenario(j.scenario).arrival) for j in group],
            [event_code(get_scenario(j.scenario).events) for j in group],
            [j.seed for j in group])
    launch = launch_for(runner, inp)
    with spans.span("fleet.start"):
        launch.start(inp, max_rate)
    emitter = (ChunkEmitter("fleet", g, len(group), runner, sink)
               if sink is not None else None)
    try:
        launched = first = resume_group(rt, g, launch, runner, emitter, sink,
                                        len(group), "fleet")
        while launched < runner.n_chunks:
            if early_stop and launched > 0 and bool(_to_host(
                    (launch.carry.drift.verdict != VERDICT_UNDECIDED).all())):
                break               # every sim decided: nothing left to run
            with spans.span("fleet.chunk", launch.device):
                if rt is not None:
                    rt.launch(g, prog.glaunch, launch.step)
                else:
                    launch.step()
            launched += 1
            prog.glaunch += 1
            if emitter is not None:
                # Snapshot the probe before the next chunk overwrites the
                # carry in place; the record is assembled off the host loop.
                with spans.span("fleet.emit"):
                    emitter.emit(runner.probe(launch.carry))
            if rt is not None:
                lane_dead = prog.drop_hosts(rt.dead_hosts(prog.glaunch),
                                            idxs)
                if lane_dead is not None:
                    # Park the dead lanes: their verdict leaf is forced
                    # UNSTABLE (frozen under early stop).
                    make_sim_rewriter(launch)(np.zeros(len(idxs), bool),
                                              lane_dead)
                if rt.should_snapshot(prog.glaunch):
                    rt.snapshot(prog.glaunch, launch.carry,
                                prog.extra(g, launched))
                # After the snapshot: a preemption here leaves a durable,
                # bit-exact resume point.
                rt.maybe_preempt(prog.glaunch)
    finally:
        if emitter is not None:
            emitter.close()
    return launched - first, launched, runner, launch
