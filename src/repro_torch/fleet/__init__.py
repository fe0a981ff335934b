"""Fleet: batched multi-scenario sweep engine (padded batching + streaming).

Public API:
  scenarios:  Scenario, register_scenario, get_scenario, list_scenarios,
              ARRIVAL_MODELS, EVENT_MODELS, ModState
  batching:   PaddedProblem, PadDims, pad_problem, stack_problems,
              make_buckets, validate_buckets, problem_shape
  engine:     FleetJob, FleetResult, run_fleet, stream_simulate,
              make_stream_runner, VerdictConfig, resolve_verdict
  report:     capacity_report, sweep_jobs, policy_bound, policy_bound_exact,
              exact_lam_star, problem_fingerprint
"""
from repro_torch.core.queues import (VERDICT_NAMES, VERDICT_STABLE,
                                     VERDICT_UNDECIDED, VERDICT_UNSTABLE)
from .scenarios import (ModState, Scenario, register_scenario, get_scenario,
                        list_scenarios, ARRIVAL_MODELS, EVENT_MODELS,
                        ARRIVAL_MODEL_ORDER, EVENT_MODEL_ORDER)
from .batching import (PaddedProblem, PadDims, make_buckets, pad_problem,
                       problem_shape, stack_problems, validate_buckets)
from .engine import (DEFAULT_VERDICT, FleetJob, FleetResult, StreamStats,
                     VerdictConfig, make_stream_runner, resolve_verdict,
                     run_fleet, stream_simulate)
from .report import (capacity_report, exact_lam_star, policy_bound,
                     policy_bound_exact, problem_fingerprint, sweep_jobs)

__all__ = [
    "ModState", "Scenario", "register_scenario", "get_scenario",
    "list_scenarios", "ARRIVAL_MODELS", "EVENT_MODELS",
    "ARRIVAL_MODEL_ORDER", "EVENT_MODEL_ORDER",
    "PaddedProblem", "PadDims", "pad_problem", "stack_problems",
    "make_buckets", "validate_buckets", "problem_shape",
    "FleetJob", "FleetResult", "StreamStats", "run_fleet",
    "stream_simulate", "make_stream_runner", "VerdictConfig",
    "DEFAULT_VERDICT", "resolve_verdict",
    "VERDICT_NAMES", "VERDICT_UNDECIDED", "VERDICT_STABLE",
    "VERDICT_UNSTABLE",
    "capacity_report", "exact_lam_star", "policy_bound",
    "policy_bound_exact", "sweep_jobs", "problem_fingerprint",
]
