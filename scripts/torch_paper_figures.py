#!/usr/bin/env python3
"""The paper's figures through the PyTorch port: Fig. 5(b), Fig. 5(c) and
the capacity table, on the card unless asked for the CPU.

The counterpart of `python -m benchmarks.run fig5b fig5c table_capacity`:
the same rates, horizons, eps_B, policies, pairings, seeds, CSV row names
(`name,us_per_call,derived`) and claims with the same thresholds, through
`repro_torch` only (numpy and scipy besides).  The port's noise is its
counter-based stream, not threefry, so a seed keeps its value but not its
draws: the claims must hold, the digits differ.

    PYTHONPATH=src python scripts/torch_paper_figures.py fig5b fig5c table_capacity
    PYTHONPATH=src python scripts/torch_paper_figures.py --device cpu fig5c
    PYTHONPATH=src python scripts/torch_paper_figures.py --device cpu --T 400 fig5b

Each suite is ``run(emit, device, T=None) -> dict``.  At the paper's
horizon (``T=None``) it asserts the paper's claims; at a cut ``T`` it
emits the same rows (Fig. 5(c)'s marks scaled to T) and records each
claim's outcome in ``out["checks"]`` without asserting it, as a short
horizon decides none of them.  ``out["checks"]`` holds the claims either
way.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np

from repro_torch.core import (PolicyConfig, capacity_upper_bound,
                              multi_stream_capacity, paper_grid_problem,
                              single_node_capacity)
from repro_torch.device import resolve_device
from repro_torch.sim import simulate, sweep_rates

# Fig. 5(b) (benchmarks/fig5b.py)
FIG5B_T = 2500
LAMS = {2.0: [4.0, 5.0, 6.0, 6.5, 7.0, 7.5, 8.0, 8.5, 9.0],
        3.0: [5.0, 6.0, 7.0, 8.0, 8.5, 9.0, 9.5, 10.0, 10.5]}
# Fig. 5(c) (benchmarks/fig5c.py)
FIG5C_T = 4000
FIG5C_LAM = 6.0
FIG5C_MARKS = (500, 1000, 2000, 4000)
# The capacity table (benchmarks/table_capacity.py)
TABLE_T = 3000


def _claim(checks: dict, name: str, ok: bool, full: bool, detail) -> None:
    checks[name] = bool(ok)
    if full:
        assert ok, (name, detail)


def fig5b(emit, device, T: int | None = None) -> dict:
    """Average total queue vs query rate, pi3 against pi3bar, C=2 and C=3:
    both share the knee, at lambda*=8 (C=2) and just below 10 (C=3)."""
    full = T is None
    T = FIG5B_T if full else T
    out, checks, lam_star = {}, {}, {}
    for C in (2.0, 3.0):
        p = paper_grid_problem(C=C)
        lam_star[C] = capacity_upper_bound(p).lam_star
        emit(f"# fig5b C={C}: LP lambda* = {lam_star[C]:.3f}")
        for name in ("pi3", "pi3bar"):
            t0 = time.time()
            res = sweep_rates(p, PolicyConfig(name=name, eps_b=0.01),
                              LAMS[C], T=T, seed=7, device=device)
            avg_q = res.total_queue.mean(1).cpu().numpy()
            du = res.delivered_useful
            rate = (du[:, -1] - du[:, T // 2]).cpu().numpy() / (T - T // 2)
            us = (time.time() - t0) / (len(LAMS[C]) * T) * 1e6
            for lam, q, r in zip(LAMS[C], avg_q, rate):
                emit(f"fig5b/C{C:g}/{name}/lam{lam:g},{us:.2f},"
                     f"avg_queue={q:.1f};useful_rate={r:.3f}")
            out[(C, name)] = (np.array(LAMS[C]), avg_q, rate)
        # capacity knee: the queue explodes past lambda*
        for name in ("pi3", "pi3bar"):
            lams, q, _ = out[(C, name)]
            below = q[lams <= lam_star[C] - 1.0]
            above = q[lams >= lam_star[C] + 0.4]
            if len(above) and len(below):
                _claim(checks, f"C{C:g}/{name}/knee",
                       above.min() > 1.5 * below.max(), full,
                       (above.min(), below.max()))
    out["lam_star"] = lam_star
    out["checks"] = checks
    return out


def fig5c(emit, device, T: int | None = None) -> dict:
    """Running averages of one pi3 run at C=2, lambda=6: the computation
    rate converges to the demand, queries split over the 4 embeddings."""
    full = T is None
    T = FIG5C_T if full else T
    p = paper_grid_problem(C=2.0)
    t0 = time.time()
    res = simulate(p, PolicyConfig(name="pi3", eps_b=0.01), FIG5C_LAM, T=T,
                   seed=11, device=device)
    comp = res.computed.cpu().numpy()
    nstar = res.n_star.cpu().numpy()
    us = (time.time() - t0) / T * 1e6
    run_comp = np.cumsum(comp) / np.arange(1, T + 1)
    emit(f"# fig5c C=2 lam={FIG5C_LAM}: running averages "
         f"(paper: comp -> lam)")
    marks = FIG5C_MARKS if full else [max(1, T * m // FIG5C_T)
                                      for m in FIG5C_MARKS]
    for t in marks:
        emit(f"fig5c/run_avg_computations/t{t},{us:.2f},"
             f"value={run_comp[t - 1]:.3f}")
    shares = np.bincount(nstar, minlength=4) / T
    for i, s in enumerate(shares):
        emit(f"fig5c/embedding_share/node{i},{us:.2f},share={s:.3f}")
    checks = {}
    # the final computation rate matches the demand (convergence claim)
    _claim(checks, "converges", abs(run_comp[-1] - FIG5C_LAM) < 0.4, full,
           run_comp[-1])
    return {"run_comp": run_comp, "shares": shares, "checks": checks}


def _sat_rate(p, cfg, lam_over: float, T: int, device) -> float:
    """The saturated useful rate of a run driven above capacity."""
    res = simulate(p, cfg, lam_over, T=T, seed=13, device=device)
    return float(res.useful_rate(T // 2))


def table_capacity(emit, device, T: int | None = None) -> dict:
    """Theorem 1/4 LP bounds against simulated saturation, single-node
    pinning, two identical streams, and the two pairing models."""
    full = T is None
    T = TABLE_T if full else T
    out, checks = {}, {}
    for C in (2.0, 3.0):
        p = paper_grid_problem(C=C)
        t0 = time.time()
        lp = capacity_upper_bound(p)
        lp_ms = (time.time() - t0) * 1e3
        sat = _sat_rate(p, PolicyConfig(name="pi3bar"), lp.lam_star + 3, T,
                        device)
        emit(f"capacity/C{C:g}/LP,{lp_ms * 1e3:.1f},"
             f"lambda_star={lp.lam_star:.3f}")
        emit(f"capacity/C{C:g}/sim_saturation,,useful_rate={sat:.3f}")
        # simulated saturation approaches, but cannot exceed, the LP bound
        _claim(checks, f"C{C:g}/sat_below_bound", sat <= lp.lam_star + 0.15,
               full, (sat, lp.lam_star))
        _claim(checks, f"C{C:g}/sat_near_bound", sat >= 0.85 * lp.lam_star,
               full, (sat, lp.lam_star))
        out[(C, "lp")] = lp.lam_star
        out[(C, "sat")] = sat

    # single-node pinning (Theorem 1) does worse here
    p = paper_grid_problem(C=2.0)
    for i in range(4):
        s = single_node_capacity(p, i).lam_star
        emit(f"capacity/C2/single_node{i},,lambda_star={s:.3f}")
        out[("single_node", i)] = s

    # multi-stream extension: identical streams share the computation
    # capacity (paper §VI)
    ms2 = multi_stream_capacity([p, p])
    emit(f"capacity/C2/two_identical_streams,,"
         f"lambda_total={ms2.lam_star:.3f}")
    _claim(checks, "two_streams_total_8", abs(ms2.lam_star - 8.0) < 1e-6,
           full, ms2.lam_star)
    out["two_streams"] = ms2.lam_star

    # pairing sensitivity: fifo against the analytic bound (7)
    for pairing in ("fifo", "bound"):
        sat = _sat_rate(p, PolicyConfig(name="pi3bar", pairing=pairing),
                        11.0, T, device)
        emit(f"capacity/C2/pairing_{pairing},,useful_rate={sat:.3f}")
        out[("pairing", pairing)] = sat
    out["checks"] = checks
    return out


SUITES = {"fig5b": fig5b, "fig5c": fig5c, "table_capacity": table_capacity}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("suites", nargs="*",
                    help=f"suites to run, of {list(SUITES)} (default: all)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--T", type=int, default=None,
                    help="a cut horizon: rows only, claims not asserted")
    args = ap.parse_args(argv)
    unknown = set(args.suites) - set(SUITES)
    if unknown:
        ap.error(f"unknown suites {sorted(unknown)}; known: {list(SUITES)}")
    device = resolve_device(args.device)
    failures = []
    print("name,us_per_call,derived")
    for name in args.suites or list(SUITES):
        t0 = time.time()
        try:
            SUITES[name](print, device, args.T)
            print(f"# suite {name} ok in {time.time() - t0:.1f}s")
        except Exception:
            failures.append(name)
            traceback.print_exc()
            print(f"# suite {name} FAILED")
    if failures:
        print(f"failed suites: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
