"""Capacity/efficiency reporting: fleet sweeps vs the Theorem-4 LP bound.

Port of `repro.fleet.report`, the atlas tables (`atlas_table`,
`policy_surface_table`) included.  For
every scenario instance the multicommodity-flow LP
(`repro_torch.core.capacity.capacity_upper_bound`) gives its capacity;
offered rates are swept as fractions of each policy's operative bound and
the measured useful rate is scored against it.

Regulated policies inflate their output by rho0 = 1 + eps_B, so their
operative bound is the exact regulated LP ``bound_exact`` (what every
efficiency here is measured against); ``bound_approx`` = lam*/rho0 is the
closed-form lower bound.  Exact solves are cached on a content hash of
the LP-determining data, bounded LRU.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.capacity import capacity_upper_bound
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.queues import VERDICT_NAMES
from repro_torch.device import resolve_device
from .engine import FleetJob, run_fleet
from .scenarios import get_scenario


def policy_bound(lam_star: float, policy: str, eps_b: float) -> float:
    """The closed-form throughput bound: lam_star/rho0 for regulated
    policies, lam_star itself otherwise."""
    return float(lam_star) / PolicyConfig(name=policy, eps_b=eps_b).rho0


#: Hard bound on cached LP scalars.
LP_CACHE_MAX = 4096

_CacheInfo = collections.namedtuple("CacheInfo",
                                    ["hits", "misses", "maxsize", "currsize"])


class _LPCache:
    """Bounded LRU of exact LP capacities keyed by problem fingerprint."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.data: "collections.OrderedDict[tuple, float]" = \
            collections.OrderedDict()
        self.hits = self.misses = 0

    def get(self, key, solve):
        hit = self.data.get(key)
        if hit is not None:
            self.data.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        val = solve()
        self.data[key] = val
        while len(self.data) > self.maxsize:
            self.data.popitem(last=False)
        return val

    def info(self) -> _CacheInfo:
        return _CacheInfo(self.hits, self.misses, self.maxsize,
                          len(self.data))

    def clear(self) -> None:
        self.data.clear()
        self.hits = self.misses = 0


_LP_CACHE = _LPCache(LP_CACHE_MAX)


def problem_fingerprint(problem, rho0: float = 1.0) -> str:
    """Content hash of the data that determines the capacity LP."""
    h = hashlib.sha256()
    g = problem.graph
    h.update(np.int64([g.n_nodes, problem.s1, problem.s2,
                       problem.dest]).tobytes())
    h.update(np.ascontiguousarray(g.edges, np.int64).tobytes())
    h.update(np.ascontiguousarray(g.capacity, np.float64).tobytes())
    h.update(np.asarray(problem.comp_nodes, np.int64).tobytes())
    h.update(np.asarray(problem.comp_caps, np.float64).tobytes())
    h.update(np.float64([rho0]).tobytes())
    return h.hexdigest()


def exact_lam_star(scenario: str, topo_seed: int, rho0: float) -> float:
    """Exact (possibly regulated) LP capacity of one scenario instance,
    LRU-cached on the problem fingerprint (``exact_lam_star.cache_info()``
    counts LP solves as misses)."""
    problem = get_scenario(scenario).build(topo_seed)
    key = ("lam_star", problem_fingerprint(problem, rho0))
    return _LP_CACHE.get(key, lambda: float(
        capacity_upper_bound(problem, rho0=rho0).lam_star))


exact_lam_star.cache_info = _LP_CACHE.info
exact_lam_star.cache_clear = _LP_CACHE.clear


def policy_bound_exact(scenario: str, policy: str, eps_b: float,
                       topo_seed: int = 0) -> float:
    """The operative throughput bound from the exact regulated LP:
    lam_star(rho0 = 1 + eps_B) for regulated policies, lam_star for the
    others."""
    rho0 = PolicyConfig(name=policy, eps_b=eps_b).rho0
    return exact_lam_star(scenario, int(topo_seed), round(float(rho0), 9))


def sweep_jobs(scenario_policies: Dict[str, Sequence[str]],
               rate_fracs: Sequence[float], seeds: Sequence[int],
               topo_seed: int = 0,
               lam_star_of: Dict[str, float] | None = None,
               eps_b: float = 0.01, exact: bool = True) -> List[FleetJob]:
    """Expand a {scenario: [policies]} spec into the job grid, offered rates
    as fractions of each policy's operative bound (exact LP by default,
    the closed-form lam_star/rho0 with ``exact=False``)."""
    jobs = []
    for scen, policies in scenario_policies.items():
        lam_star = (lam_star_of or {}).get(scen)
        if lam_star is None and not exact:
            lam_star = exact_lam_star(scen, int(topo_seed), 1.0)
        for pol in policies:
            if exact:
                bound = policy_bound_exact(scen, pol, eps_b,
                                           topo_seed=topo_seed)
            else:
                bound = policy_bound(lam_star, pol, eps_b)
            for frac in rate_fracs:
                for seed in seeds:
                    jobs.append(FleetJob(scenario=scen, policy=pol,
                                         lam=float(frac) * bound,
                                         seed=int(seed),
                                         topo_seed=topo_seed,
                                         eps_b=float(eps_b)))
    return jobs


def _ratio_band(ratios: np.ndarray) -> dict:
    """The per-family λ_max confidence band: q10/q90 of
    the ratio distribution over the family's (cell × topo_seed) rows plus
    the band width.  Quantiles use the ``lower`` method so the band is a
    pair of *measured* cell ratios (deterministic, dispatch-order
    invariant) rather than an interpolation artifact."""
    q10 = float(np.quantile(ratios, 0.10, method="lower"))
    q90 = float(np.quantile(ratios, 0.90, method="lower"))
    return {"q10": q10, "q90": q90, "width": q90 - q10}


def atlas_table(result) -> dict:
    """JSON-serializable capacity-atlas table.

    Takes an `atlas.AtlasResult` (duck-typed: anything with its fields
    works, which keeps this module import-free of `fleet.atlas`) and
    summarizes the measured-vs-LP frontier per scenario family: ratio
    median/min/max and the q10–q90 seed-replication band over the
    family's cells, how many cells ended UNDECIDED at the bracket top
    (horizon-limited localization, DESIGN.md §8) vs proven UNSTABLE, how
    many were rescued by adaptive re-queues, plus the fleet-level
    launch + bucket accounting the atlas bench gates on."""
    fam: Dict[str, list] = {}
    for r in result.rows:
        fam.setdefault(r.scenario, []).append(r)
    families = {}
    # Canonical order — (policy, topo_seed) within a family, families by
    # name — so the table is invariant to cell dispatch order and seed-
    # band entries diff cleanly in CI.
    for scen in sorted(fam):
        rows = sorted(fam[scen], key=lambda r: (r.policy, r.topo_seed))
        ratios = np.array([r.ratio for r in rows])
        families[scen] = {
            "n_cells": len(rows),
            "ratio_median": float(np.median(ratios)),
            "ratio_min": float(ratios.min()),
            "ratio_max": float(ratios.max()),
            "band": _ratio_band(ratios),
            "n_undecided_hi": int(sum(r.undecided for r in rows)),
            "n_requeued": int(sum(r.n_requeues > 0 for r in rows)),
            "n_calls_mean": float(np.mean([r.n_calls for r in rows])),
            "bound_exact_mean": float(np.mean([r.bound_exact
                                               for r in rows])),
            "cells": [
                {"topo_seed": r.topo_seed, "lam_max": r.lam_max,
                 "bound_exact": r.bound_exact, "ratio": r.ratio,
                 "lo": r.lo, "hi": r.hi, "n_calls": r.n_calls,
                 "undecided_hi": bool(r.undecided),
                 "hi_certain": r.hi_certain,
                 "bucket": r.bucket, "n_requeues": r.n_requeues}
                for r in rows],
        }
    return {
        "n_cells": result.n_cells,
        "n_lanes": result.n_lanes,
        "n_programs": result.n_programs,
        "n_launches": result.n_launches,
        "seq_launches": result.seq_launches,
        "launch_speedup": result.launch_speedup,
        "n_rewrites": result.n_rewrites,
        "n_step_compiles": result.n_step_compiles,
        "slots_saved": result.slots_saved,
        "full_slots": result.full_slots,
        "launch_slots_saved": result.launch_slots_saved,
        "pad_dims": {"n_nodes": result.dims.n_nodes,
                     "n_edges": result.dims.n_edges,
                     "n_comp": result.dims.n_comp},
        "n_buckets": result.n_buckets,
        "bucket_dims": [{"n_nodes": d.n_nodes, "n_edges": d.n_edges,
                         "n_comp": d.n_comp}
                        for d in result.bucket_dims],
        "bucket_cells": {str(b): int(n)
                         for b, n in sorted(result.bucket_cells.items())},
        "bucket_launches": {str(b): int(n)
                            for b, n in
                            sorted(result.bucket_launches.items())},
        "n_requeues": result.n_requeues,
        "T": result.T, "chunk": result.chunk,
        "families": families,
    }


def policy_surface_table(result) -> dict:
    """Pivot an atlas-over-policies sweep (`atlas.sweep_policy_surface`)
    into the policy-surface table: per (policy × family) ratio medians and
    q10–q90 bands over the shared topology grid, so policies compare on
    identical cells against identical exact bounds.  The
    per-family ``gap_vs`` entries report each policy's median-ratio gap
    to the best policy on that family."""
    surf: Dict[str, Dict[str, list]] = {}
    for r in result.rows:
        surf.setdefault(r.policy, {}).setdefault(r.scenario, []).append(r)
    policies = {}
    for pol in sorted(surf):        # canonical order, like atlas_table
        fams = surf[pol]
        entry = {}
        for scen in sorted(fams):
            rows = fams[scen]
            ratios = np.array([r.ratio for r in rows])
            entry[scen] = {
                "n_cells": len(rows),
                "ratio_median": float(np.median(ratios)),
                "band": _ratio_band(ratios),
                "n_undecided_hi": int(sum(r.undecided for r in rows)),
            }
        policies[pol] = entry
    fam_names = sorted({s for fams in surf.values() for s in fams})
    best = {scen: max(policies[p][scen]["ratio_median"]
                      for p in policies if scen in policies[p])
            for scen in fam_names}
    for pol, entry in policies.items():
        for scen, row in entry.items():
            row["gap_vs_best"] = best[scen] - row["ratio_median"]
    return {
        "n_cells": result.n_cells,
        "n_policies": len(policies),
        "families": fam_names,
        "policies": policies,
    }


def capacity_report(scenario_policies: Dict[str, Sequence[str]],
                    rate_fracs: Sequence[float], seeds: Sequence[int],
                    T: int, chunk: int = 1024, window: int | None = None,
                    topo_seed: int = 0, device=None,
                    eps_b: float = 0.01,
                    early_stop: bool = False) -> dict:
    """Run the sweep and assemble the capacity/efficiency table (the
    layout of `repro.fleet.report.capacity_report`)."""
    device = resolve_device(device)
    lam_star_of = {
        scen: exact_lam_star(scen, int(topo_seed), 1.0)
        for scen in scenario_policies}
    rho0_of = {pol: PolicyConfig(name=pol, eps_b=eps_b).rho0
               for pols in scenario_policies.values() for pol in pols}
    bound_of = {
        (scen, pol): policy_bound_exact(scen, pol, eps_b,
                                        topo_seed=topo_seed)
        for scen, pols in scenario_policies.items() for pol in pols}
    jobs = sweep_jobs(scenario_policies, rate_fracs, seeds,
                      topo_seed=topo_seed, eps_b=eps_b, exact=True)
    res = run_fleet(jobs, T=T, chunk=chunk, window=window, device=device,
                    early_stop=early_stop)

    table: dict = {
        "T": res.T, "window": res.window,
        "n_sims": res.n_sims, "n_programs": res.n_programs,
        "device": res.device,
        "pad_dims": {"n_nodes": res.dims.n_nodes, "n_edges": res.dims.n_edges,
                     "n_comp": res.dims.n_comp},
        "rate_fracs": [float(f) for f in rate_fracs],
        "scenarios": {},
    }
    for scen, policies in scenario_policies.items():
        lam_star = lam_star_of[scen]
        entry = {"lam_star": lam_star, "policies": {}}
        for pol in policies:
            rows = [(job, m) for job, m in zip(res.jobs, res.metrics)
                    if job.scenario == scen and job.policy == pol]
            useful = np.array([m["useful_rate"] for _, m in rows])
            offered = np.array([m["offered"] for _, m in rows])
            stable = np.array([m["stable"] for _, m in rows]) > 0.5
            best = float(useful.max()) if len(useful) else 0.0
            stable_offered = offered[stable] if stable.any() else np.array([0.0])
            bound_exact = bound_of[(scen, pol)]
            entry["policies"][pol] = {
                "best_useful_rate": best,
                "rho0": rho0_of[pol],
                "bound": bound_exact,
                "bound_exact": bound_exact,
                "bound_approx": policy_bound(lam_star, pol, eps_b),
                "efficiency": best / bound_exact if bound_exact > 0 else 0.0,
                "max_stable_offered": float(stable_offered.max()),
                "mean_queue_at_best": float(
                    rows[int(useful.argmax())][1]["mean_queue"]) if rows else 0.0,
                "points": [
                    {"offered": float(m["offered"]),
                     "useful_rate": float(m["useful_rate"]),
                     "stable": bool(m["stable"] > 0.5),
                     "verdict": VERDICT_NAMES[int(m["verdict"])],
                     "decided_at_slot": int(m["decided_at_slot"]),
                     "slots_saved": int(m["slots_saved"]),
                     "mean_queue": float(m["mean_queue"]),
                     "max_queue": float(m["max_queue"])}
                    for _, m in rows],
            }
        table["scenarios"][scen] = entry
    return table
