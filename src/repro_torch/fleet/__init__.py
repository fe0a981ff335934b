"""Fleet: batched multi-scenario sweep engine (padded batching + streaming).

Public API:
  scenarios:  Scenario, register_scenario, get_scenario, list_scenarios,
              ARRIVAL_MODELS, EVENT_MODELS, ModState
  batching:   PaddedProblem, PadDims, pad_problem, stack_problems,
              make_buckets, validate_buckets, problem_shape
  engine:     FleetJob, FleetResult, run_fleet, stream_simulate,
              make_stream_runner, make_group_launch, make_sim_rewriter,
              GroupLaunch, VerdictConfig, resolve_verdict
  report:     capacity_report, sweep_jobs, policy_bound, policy_bound_exact,
              exact_lam_star, atlas_table, policy_surface_table,
              problem_fingerprint
  frontier:   find_lambda_max, FrontierResult, RateProbe, fold_seed,
              Bisection
  atlas:      sweep_lambda_max, sweep_policy_surface, registry_cells,
              AtlasJob, AtlasRow, AtlasResult
"""
from repro_torch.core.queues import (VERDICT_NAMES, VERDICT_STABLE,
                                     VERDICT_UNDECIDED, VERDICT_UNSTABLE)
from .scenarios import (ModState, Scenario, register_scenario, get_scenario,
                        list_scenarios, ARRIVAL_MODELS, EVENT_MODELS,
                        ARRIVAL_MODEL_ORDER, EVENT_MODEL_ORDER)
from .batching import (PaddedProblem, PadDims, make_buckets, pad_problem,
                       problem_shape, stack_problems, validate_buckets)
from .engine import (DEFAULT_VERDICT, FleetJob, FleetResult, GroupLaunch,
                     StreamStats, VerdictConfig, make_group_launch,
                     make_sim_rewriter, make_stream_runner, resolve_verdict,
                     run_fleet, stream_simulate)
from .report import (atlas_table, capacity_report, exact_lam_star,
                     policy_bound, policy_bound_exact, policy_surface_table,
                     problem_fingerprint, sweep_jobs)
from .frontier import (Bisection, FrontierResult, RateProbe, find_lambda_max,
                       fold_seed)
from .atlas import (AtlasJob, AtlasResult, AtlasRow, registry_cells,
                    sweep_lambda_max, sweep_policy_surface)

__all__ = [
    "ModState", "Scenario", "register_scenario", "get_scenario",
    "list_scenarios", "ARRIVAL_MODELS", "EVENT_MODELS",
    "ARRIVAL_MODEL_ORDER", "EVENT_MODEL_ORDER",
    "PaddedProblem", "PadDims", "pad_problem", "stack_problems",
    "make_buckets", "validate_buckets", "problem_shape",
    "FleetJob", "FleetResult", "StreamStats", "run_fleet",
    "stream_simulate", "make_stream_runner", "make_group_launch",
    "make_sim_rewriter", "GroupLaunch", "VerdictConfig",
    "DEFAULT_VERDICT", "resolve_verdict",
    "VERDICT_NAMES", "VERDICT_UNDECIDED", "VERDICT_STABLE",
    "VERDICT_UNSTABLE",
    "capacity_report", "exact_lam_star", "policy_bound",
    "policy_bound_exact", "sweep_jobs", "problem_fingerprint",
    "atlas_table", "policy_surface_table",
    "Bisection", "FrontierResult", "RateProbe", "find_lambda_max",
    "fold_seed",
    "AtlasJob", "AtlasResult", "AtlasRow", "registry_cells",
    "sweep_lambda_max", "sweep_policy_surface",
]
