"""Serving report: delivered QPS and sojourn latency scored against the
exact regulated LP bound, plus the stream JSONL writer.

Port of `repro.serving.report`.  The yardstick is the fleet's
(`fleet.report.policy_bound_exact`): serving is scored against the same
LP the open-loop sweeps use, and ``delivered_qps / bound`` is the
headline number `benchmarks/bench_serving.py` gates.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.queues import VERDICT_NAMES
from repro_torch.fleet.engine import VerdictConfig
from repro_torch.fleet.report import policy_bound_exact
# The JSONL helpers live in the telemetry plane's schema module; they are
# re-exported here as in the reference.
from repro_torch.obs.schema import jsonl_line, write_stream_jsonl  # noqa: F401
from .admission import AdmissionConfig
from .engine import ServingJob, run_serving


def serving_report(scenario: str, policy: str, trace: str,
                   rate_fracs: Sequence[float], seeds: Sequence[int],
                   T: int, chunk: int = 512, window: int | None = None,
                   eps_b: float = 0.05, topo_seed: int = 0, device=None,
                   verdict: VerdictConfig | None = None,
                   admission: AdmissionConfig | None = None,
                   stream: bool = False) -> dict:
    """Sweep offered-rate fractions of the exact bound over one trace on
    ``device`` (CUDA unless the caller asks for the CPU).

    Returns ``{"bound_exact", "rows": {frac: {...}}, "result", ...}`` where
    each row aggregates the seeds at that rate: delivered QPS (mean/min
    over seeds) and its ratio to the bound, shed fraction, p50/p99/mean
    sojourn, gate statistics, verdict names.  ``result`` is the raw
    `ServingResult` (stream records included when ``stream`` is on).
    """
    bound = policy_bound_exact(scenario, policy, eps_b, topo_seed)
    jobs = [ServingJob(scenario=scenario, policy=policy, trace=trace,
                       lam=frac * bound, seed=seed, topo_seed=topo_seed,
                       eps_b=eps_b)
            for frac in rate_fracs for seed in seeds]
    res = run_serving(jobs, T, chunk=chunk, window=window, device=device,
                      verdict=verdict, admission=admission, stream=stream)

    rows: dict = {}
    per_seed = len(seeds)
    for fi, frac in enumerate(rate_fracs):
        ms = res.metrics[fi * per_seed:(fi + 1) * per_seed]

        def agg(name, red=np.mean):
            return float(red([m[name] for m in ms]))

        rows[f"{frac:g}"] = {
            "offered": float(frac * bound),
            "delivered_qps": agg("delivered_qps"),
            "delivered_qps_min": agg("delivered_qps", np.min),
            "delivered_over_bound": agg("delivered_qps") / bound,
            "admitted_rate": agg("admitted_rate"),
            "shed_frac": agg("shed_frac"),
            "shed_frac_max": agg("shed_frac", np.max),
            "p50_sojourn": agg("p50_sojourn"),
            "p99_sojourn": agg("p99_sojourn"),
            "p99_sojourn_max": agg("p99_sojourn", np.max),
            "mean_sojourn": agg("mean_sojourn"),
            "gate_open_frac": agg("gate_open_frac"),
            "gate_flips": agg("gate_flips", np.sum),
            "verdicts": sorted({VERDICT_NAMES[int(m["verdict"])]
                                for m in ms}),
        }
    return {"scenario": scenario, "policy": policy, "trace": trace,
            "eps_b": eps_b, "bound_exact": float(bound),
            "T": res.T, "n_sims": res.n_sims, "rows": rows, "result": res}
