"""Adaptive λ_max frontier search: bisection over early-stopped fleet runs.

Port of `repro.fleet.frontier`.  `find_lambda_max` measures the paper's
headline quantity, the maximum sustainable query rate λ_max: it brackets
the exact regulated LP bound (`fleet.report.policy_bound_exact`), then
bisects the offered rate over successive `run_fleet` calls, each
early-stopped by the streaming stability verdict; a rate is *sustainable*
iff every seed's sim latches STABLE.  The search contract:

  * **Grid quantization.**  Probed rates live on the fixed grid
    ``lam = k * rel_tol * bound`` (integer ``k``), so bisection from any
    valid initial bracket converges to the same boundary index; the final
    bracket is one grid step wide.
  * **Seed decoupling.**  Each probe's per-seed noise seeds are SplitMix64
    folds of ``(topo_seed, rate_index, call_index, seed)`` (`fold_seed`),
    not the raw job seed, so two probes at different rates never share
    arrival streams.  Every grid index is evaluated at most once per
    search, always with ``call_index = 0``; a driver that re-probes a rate
    passes ``call_index > 0`` to draw fresh noise.
  * **Launch-only steps.**  Every probe runs the same memoized
    `make_stream_runner`/`make_group_launch` at the same shape, with its
    Poisson tables sized once for the bracket's top, so the search
    captures its chunk once and every later probe only replays it:
    ``FrontierResult.n_step_compiles == 1``.

Verdict aggregation is conservative: UNDECIDED (like UNSTABLE) counts as
unsustainable, so λ_max is biased down, never above the true frontier.
The two outcomes are recorded apart: a probe's ``undecided`` flag (no seed
latched UNSTABLE) and the result's ``undecided`` flag (the bracket's upper
end was never proven unstable).

The control flow lives in the pure `Bisection` state machine, so this
sequential driver and the batched capacity atlas (`fleet.atlas`) advance
bit-identical searches given the same verdict oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim.workload import mix64
from .engine import FleetJob, VerdictConfig, run_fleet
from .report import policy_bound_exact

_M64 = (1 << 64) - 1


def _int64(x: int) -> int:
    """An unsigned 64-bit value as the int64 with the same bits."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def fold_seed(topo_seed: int, rate_index: int, call_index: int,
              seed: int = 0) -> int:
    """Derive one probe's noise seed from the bisection coordinates.

    SplitMix64 (`repro_torch.sim.workload.mix64`, the finalizer of the
    port's noise stream) over a weighted sum of ``(topo_seed, rate_index,
    call_index, seed)``, bit for bit the reference's fold.  Returns a
    non-negative int31."""
    h = (0x9E3779B97F4A7C15 * (topo_seed & _M64)
         + 0xBF58476D1CE4E5B9 * (rate_index & _M64)
         + 0x94D049BB133111EB * (call_index & _M64)
         + 0xD6E8FEB86659FD93 * (seed & _M64) + 0x2545F4914F6CDD1D) & _M64
    mixed = mix64(torch.tensor(_int64(h), dtype=torch.int64))
    return int(mixed) & 0x7FFFFFFF


class Bisection:
    """Pure pull-based bisection state machine for one frontier cell.

    The control flow of `find_lambda_max` (shrink the floor, ``k_lo //= 2``
    until sustainable; push the ceiling, ``k_hi *= 2`` while sustainable;
    then integer bisection) inverted into a machine the driver pulls
    probes from: `next_rate_index()` returns the grid index to evaluate
    next (None when the search is finished), and `record(k, sustainable,
    undecided)` feeds the verdict back.  Cached indices and the
    ``max_calls`` budget are consumed internally, so a driver never sees a
    repeat probe.  `undecided_hi` flags a final upper end that was never
    proven unstable; `k_hi_certain` is the smallest index with genuine
    UNSTABLE evidence (None if none).  A copy of the reference's machine,
    step for step, so both packages probe the same indices in the same
    order."""

    def __init__(self, k_lo: int, k_hi: int, max_calls: int = 24):
        self.k_lo = max(int(k_lo), 0)
        self.k_hi = max(int(k_hi), self.k_lo + 1)
        self.max_calls = int(max_calls)
        self.n_evals = 0             # probes actually evaluated (the budget)
        self.n_iters = 0             # bisection halvings (excl. validation)
        # k -> (sustainable, undecided)
        self.outcomes: Dict[int, Tuple[bool, bool]] = {}
        self._phase = "lo"           # lo -> hi -> mid -> done
        self._pending: Optional[int] = None
        self._mid_pending: Optional[int] = None
        self.done = False

    def _resolve(self, k: int) -> Tuple[bool, bool]:
        """evaluate(k) without launching: (resolved, sustainable)."""
        if k <= 0:
            return True, True        # lam = 0 is trivially sustainable
        if k in self.outcomes:
            return True, self.outcomes[k][0]
        if self.n_evals >= self.max_calls:
            return True, False       # budget exhausted: stay conservative
        return False, False

    def next_rate_index(self) -> Optional[int]:
        """The next grid index to probe, or None when the search is done.
        Idempotent while a probe is outstanding."""
        if self._pending is not None:
            return self._pending
        while not self.done:
            if self._phase == "lo":
                if self.k_lo <= 0:
                    self._phase = "hi"
                    continue
                resolved, ok = self._resolve(self.k_lo)
                if not resolved:
                    self._pending = self.k_lo
                    return self.k_lo
                if ok:
                    self._phase = "hi"
                else:
                    self.k_lo //= 2
            elif self._phase == "hi":
                resolved, ok = self._resolve(self.k_hi)
                if not resolved:
                    self._pending = self.k_hi
                    return self.k_hi
                if ok and self.n_evals < self.max_calls:
                    self.k_lo = max(self.k_lo, self.k_hi)
                    self.k_hi *= 2
                else:
                    self._phase = "mid"
            else:
                if self._mid_pending is not None:
                    # A bisection iteration that issued a probe finishes
                    # after the budget check it already passed.
                    mid, self._mid_pending = self._mid_pending, None
                    if self.outcomes[mid][0]:
                        self.k_lo = mid
                    else:
                        self.k_hi = mid
                    self.n_iters += 1
                    continue
                if self.k_hi - self.k_lo <= 1 or \
                        self.n_evals >= self.max_calls:
                    self.done = True
                    break
                mid = (self.k_lo + self.k_hi) // 2
                resolved, ok = self._resolve(mid)
                if not resolved:
                    self._pending = mid
                    self._mid_pending = mid
                    return mid
                if ok:
                    self.k_lo = mid
                else:
                    self.k_hi = mid
                self.n_iters += 1
        return None

    def record(self, k: int, sustainable: bool,
               undecided: bool = False) -> None:
        """Resolve the pending probe.  ``undecided`` marks a probe blocked
        only by UNDECIDED-at-horizon seeds (no UNSTABLE evidence)."""
        if k != self._pending:
            raise ValueError(f"recorded k={k} but pending probe is "
                             f"{self._pending}")
        self.outcomes[k] = (bool(sustainable), bool(undecided))
        self.n_evals += 1
        self._pending = None

    def to_state(self) -> dict:
        """The machine as JSON-serializable data (a bit-exact resume)."""
        return {"k_lo": self.k_lo, "k_hi": self.k_hi,
                "max_calls": self.max_calls, "n_evals": self.n_evals,
                "n_iters": self.n_iters,
                "outcomes": [[k, ok, und]
                             for k, (ok, und) in self.outcomes.items()],
                "phase": self._phase, "pending": self._pending,
                "mid_pending": self._mid_pending, "done": self.done}

    @classmethod
    def from_state(cls, state: dict) -> "Bisection":
        b = cls(1, 2)                       # placeholders, overwritten below
        b.k_lo = int(state["k_lo"])
        b.k_hi = int(state["k_hi"])
        b.max_calls = int(state["max_calls"])
        b.n_evals = int(state["n_evals"])
        b.n_iters = int(state["n_iters"])
        b.outcomes = {int(k): (bool(ok), bool(und))
                      for k, ok, und in state["outcomes"]}
        b._phase = state["phase"]
        b._pending = (None if state["pending"] is None
                      else int(state["pending"]))
        b._mid_pending = (None if state["mid_pending"] is None
                          else int(state["mid_pending"]))
        b.done = bool(state["done"])
        return b

    @property
    def undecided_hi(self) -> bool:
        """Final upper end blocked by horizon-limited (UNDECIDED) evidence
        rather than a proven UNSTABLE verdict."""
        o = self.outcomes.get(self.k_hi)
        return bool(o is not None and not o[0] and o[1])

    @property
    def k_hi_certain(self) -> Optional[int]:
        """Smallest probed index with genuinely UNSTABLE evidence."""
        certain = [k for k, (ok, und) in self.outcomes.items()
                   if not ok and not und]
        return min(certain) if certain else None


@dataclasses.dataclass(frozen=True)
class RateProbe:
    """One evaluated rate of the frontier search."""

    rate_index: int          # grid index k (lam = k * rel_tol * bound)
    call_index: int          # how many times this rate had been probed before
    lam: float
    sustainable: bool        # all seeds latched STABLE
    verdicts: Tuple[str, ...]
    decided_at: Tuple[int, ...]
    slots_run: int           # simulated slots actually advanced
    slots_saved: int         # simulated slots the freeze skipped
    undecided: bool = False  # unsustainable only for lack of evidence


@dataclasses.dataclass(frozen=True)
class FrontierResult:
    """Outcome of `find_lambda_max`."""

    scenario: str
    policy: str
    eps_b: float
    topo_seed: int
    lam_max: float           # largest grid rate verified sustainable
    bound_exact: float       # the exact regulated LP bound
    ratio: float             # lam_max / bound_exact
    lo: float                # final bracket: sustainable side
    hi: float                # final bracket: unsustainable side
    n_calls: int             # run_fleet calls issued
    n_iters: int             # bisection halvings (excl. bracket validation)
    total_slots: int         # simulated slots advanced across all probes
    full_slots: int          # slots a no-early-stop search would have run
    slots_saved: int         # full_slots - total_slots
    launch_slots_saved: int  # sim-slots of chunks never run
    n_step_compiles: int     # chunk programs the search ran (must be 1):
                             # graph captures on CUDA, launchers on the CPU
    probes: Tuple[RateProbe, ...]
    undecided: bool = False  # the upper end was never proven unstable
    hi_certain: float | None = None  # smallest rate with UNSTABLE evidence

    @property
    def slots_saved_frac(self) -> float:
        return self.slots_saved / self.full_slots if self.full_slots else 0.0


def bracket_indices(bound: float, step: float,
                    bracket: Tuple[float, float]) -> Tuple[int, int]:
    """The initial integer bracket (k_lo, k_hi) of a search: ``bracket``'s
    fractions of ``bound`` on the grid of ``step``."""
    return (max(int(np.floor(bracket[0] * bound / step)), 0),
            max(int(np.ceil(bracket[1] * bound / step)), 1))


def find_lambda_max(scenario: str, policy: str = "pi3", *,
                    eps_b: float = 0.01, topo_seed: int = 0,
                    seeds: Sequence[int] = (0, 1), T: int = 4096,
                    chunk: int = 512, window: int | None = None,
                    rel_tol: float = 0.025,
                    bracket: Tuple[float, float] = (0.5, 1.1),
                    max_calls: int = 24, early_stop: bool = True,
                    verdict: VerdictConfig | None = None,
                    device=None, dims=None,
                    stream_log=None) -> FrontierResult:
    """Locate the empirical λ_max of one (scenario, policy) pair by
    bisecting the offered rate over early-stopped `run_fleet` calls on
    ``device`` (CUDA unless the caller asks for the CPU).

    ``bracket`` is the initial (lo, hi) as fractions of the exact bound;
    it is validated first and expanded or shrunk on the grid if need be.
    Every probe runs ``len(seeds)`` sims; it is sustainable iff all latch
    STABLE.  ``dims`` pins the padded topology dims (the atlas equivalence
    tests pass the atlas-wide dims here).  ``stream_log`` taps every
    probe's per-chunk telemetry: it is handed to each `run_fleet` call, so
    records restart their (group, chunk, t) clocks per probe, a live
    progress feed rather than one monotone stream (the atlas emits
    that)."""
    dev = resolve_device(device)
    bound = policy_bound_exact(scenario, policy, eps_b, topo_seed=topo_seed)
    if bound <= 0.0:
        raise ValueError(f"{scenario}: exact LP bound is {bound}; "
                         "nothing to bisect")
    step = rel_tol * bound
    seeds = tuple(seeds)

    probes: List[RateProbe] = []
    launch_saved = n_compiles = 0
    k_lo, k_hi = bracket_indices(bound, step, bracket)
    bis = Bisection(k_lo=k_lo, k_hi=k_hi, max_calls=max_calls)
    while (k := bis.next_rate_index()) is not None:
        jobs = [FleetJob(scenario=scenario, policy=policy, lam=k * step,
                         eps_b=eps_b, topo_seed=topo_seed,
                         seed=fold_seed(topo_seed, k, 0, s))
                for s in seeds]
        res = run_fleet(jobs, T=T, chunk=chunk, window=window,
                        early_stop=early_stop, verdict=verdict,
                        device=dev, dims=dims,
                        max_rate=max(k_lo + 1, k_hi) * step,
                        stream_log=stream_log)
        launch_saved += res.launch_slots_saved
        n_compiles = res.n_step_compiles
        names = res.verdicts()
        sustainable = all(v == "STABLE" for v in names)
        probe = RateProbe(
            rate_index=k, call_index=0, lam=k * step,
            sustainable=sustainable,
            verdicts=tuple(names),
            decided_at=tuple(int(d)
                             for d in res.column("decided_at_slot")),
            slots_run=res.n_sims * res.T - res.slots_saved,
            slots_saved=res.slots_saved,
            undecided=not sustainable and "UNSTABLE" not in names)
        probes.append(probe)
        bis.record(k, probe.sustainable, probe.undecided)

    full = sum(p.slots_run + p.slots_saved for p in probes)
    run_slots = sum(p.slots_run for p in probes)
    return FrontierResult(
        scenario=scenario, policy=policy, eps_b=eps_b, topo_seed=topo_seed,
        lam_max=bis.k_lo * step, bound_exact=bound,
        ratio=bis.k_lo * step / bound,
        lo=bis.k_lo * step, hi=bis.k_hi * step,
        n_calls=len(probes), n_iters=bis.n_iters,
        total_slots=run_slots, full_slots=full,
        slots_saved=full - run_slots,
        launch_slots_saved=launch_saved,
        n_step_compiles=n_compiles,
        probes=tuple(probes),
        undecided=bis.undecided_hi,
        hi_certain=(None if bis.k_hi_certain is None
                    else bis.k_hi_certain * step))
