#!/usr/bin/env python3
"""Do the fleet verdicts of the port hang on float32 summation order?

The plain slot step scatters its updates with `kernels.bp_slot.ref.
scatter_add`.  On the CPU that adds each update to the base in list
order; the card's plain path (sorted scatter-adds) sums an index's
updates first and then adds the base.  Both are rounding of one
computation.  This script runs `chip_smoke.main_jobs()` (the 1,512-sim
main path: 8 families x 21 topologies x 3 rates x 3 seeds, hull
N=16/E=51/N_C=4, pi3_reg, early stop) on the CPU through the plain slot
step in both orders, in lockstep, from the same port noise, and lists
the sims whose verdicts split.

    PYTHONPATH=src python scripts/torch_verdict_rounding.py split \
        --out build/verdict_split.json [--T 4096 --chunk 512 --limit 0]

For every sim it records the margin of its closest verdict evaluation
(drift and gap against the thresholds of `drift_verdict_update`, over
max(lam, 1)) up to its decision, the largest difference of the two
orders' drift and gap estimates, and of their backlogs and useful
deliveries.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_verdict_rounding.py \
        reference --split build/verdict_split.json [--extra 24]

feeds the reference's noise (one numpy Poisson arrival trace per sim and
the JAX runner's own regulator bits) to the split sims whose scenario
draws no event noise, plus ``--extra`` unsplit sims of those scenarios,
through `repro.fleet.engine.stream_simulate` and through the port in both
orders, and counts which order agrees with the reference's verdict.
That step imports JAX (it compares the two packages, as the parity tests
do); the `split` step does not.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.fleet import engine  # noqa: E402
from repro_torch.fleet.batching import from_leaves, pad_leaves  # noqa: E402
from repro_torch.fleet.scenarios import (arrival_code, event_code,  # noqa: E402
                                         get_scenario)
from repro_torch.kernels.bp_slot import ref as tref  # noqa: E402

IN_ORDER = tref.scatter_add
#: Scenarios of the main path whose runs draw no event noise: the
#: reference's noise reaches them through the seam (arrivals, regulator).
NOISE_FREE_EVENTS = ("static",)


def summed_first(base, idx, vals):
    """The card's plain scatter order: an index's updates summed from zero
    first, then added to the base."""
    return base + IN_ORDER(torch.zeros_like(base), idx, vals)


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def batch_of(jobs, dims):
    pp = from_leaves([pad_leaves(get_scenario(j.scenario).build(j.topo_seed),
                                 dims) for j in jobs],
                     dims.n_nodes, dims.n_comp, "cpu")
    return engine.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [arrival_code(get_scenario(j.scenario).arrival) for j in jobs],
        [event_code(get_scenario(j.scenario).events) for j in jobs],
        [j.seed for j in jobs])


def estimates(carry, lam):
    """[2, B] the last counted evaluation's drift and gap over max(lam, 1),
    the quantities `drift_verdict_update` holds to its thresholds."""
    scale = torch.clamp(lam, min=1.0)
    return torch.stack([carry.drift.last_drift / scale,
                        (lam - carry.drift.last_rate) / scale])


def margins(runner, carry, lam):
    """[B] distance of the last counted evaluation from the nearest of the
    verdict's thresholds (drift_tol, 2 drift_tol, gap_tol), over
    max(lam, 1)."""
    v = runner.verdict
    drift, gap = estimates(carry, lam)
    return torch.stack([(drift - v.drift_tol).abs(),
                        (drift - 2 * v.drift_tol).abs(),
                        (gap - v.gap_tol).abs()]).min(0).values


def slot_in_order(runner, inp, carry, order, arrivals=None, reg=None):
    tref.scatter_add = order
    try:
        runner.advance(inp, carry, arrivals, reg)
    finally:
        tref.scatter_add = IN_ORDER


def lockstep(runner, inp, arrivals=None, reg=None, early_stop=True):
    """Both orders from the same noise, slot by slot.  Returns the two
    final carries; each sim's smallest margin (of either order) over the
    evaluations while either order was undecided; the largest difference
    of the two orders' drift and gap estimates at the evaluations while
    both were undecided; and
    the largest |difference| of total backlog and of useful deliveries
    between the orders at any chunk boundary."""
    B = inp.pp.batch
    cA, cB = runner.init_carry(inp.pp), runner.init_carry(inp.pp)
    lam = inp.lam
    worst = torch.full((B,), float("inf"))
    dest = torch.zeros(B)
    dq = torch.zeros(B)
    du = torch.zeros(B)
    counted_from = runner.verdict_burn_in + 2 * runner.verdict_window
    for c in range(runner.n_chunks):
        openA = cA.drift.verdict == engine.VERDICT_UNDECIDED
        openB = cB.drift.verdict == engine.VERDICT_UNDECIDED
        undecided, both_before = openA | openB, openA & openB
        for s in range(runner.chunk):
            k = c * runner.chunk + s
            a = None if arrivals is None else arrivals[:, k]
            r = None if reg is None else reg[:, k]
            slot_in_order(runner, inp, cA, IN_ORDER, a, r)
            slot_in_order(runner, inp, cB, summed_first, a, r)
        t = (c + 1) * runner.chunk
        if t >= counted_from:
            m = torch.minimum(margins(runner, cA, lam),
                              margins(runner, cB, lam))
            worst = torch.where(undecided, torch.minimum(worst, m), worst)
            gapd = (estimates(cA, lam) - estimates(cB, lam)).abs().max(0)
            dest = torch.where(both_before, torch.maximum(dest, gapd.values),
                               dest)
        qa = cA.state.Q.sum(dim=(1, 2, 3))
        qb = cB.state.Q.sum(dim=(1, 2, 3))
        dq = torch.maximum(dq, (qa - qb).abs())
        du = torch.maximum(du, (cA.state.delivered_useful -
                                cB.state.delivered_useful).abs())
        done = bool(((cA.drift.verdict != engine.VERDICT_UNDECIDED) &
                     (cB.drift.verdict != engine.VERDICT_UNDECIDED)).all())
        if early_stop and done and c + 1 < runner.n_chunks:
            break
    return cA, cB, worst, dest, dq, du


def cmd_split(args):
    smoke = load_smoke()
    jobs, bounds = smoke.main_jobs()
    if args.limit:
        step = max(len(jobs) // args.limit, 1)
        keep = list(range(0, len(jobs), step))[:args.limit]
        jobs = [jobs[i] for i in keep]
        bounds = [bounds[i] for i in keep]
    dims = engine.PadDims(smoke.N_MAIN, smoke.E_MAIN, smoke.NC_MAIN)
    inp = batch_of(jobs, dims)
    runner = engine.make_stream_runner(
        PolicyConfig("pi3_reg", eps_b=smoke.EPS_B), T=args.T,
        chunk=args.chunk, verdict=engine.resolve_verdict(None, True))
    torch.set_grad_enabled(False)
    t0 = time.perf_counter()
    cA, cB, worst, dest, dq, du = lockstep(runner, inp)
    secs = time.perf_counter() - t0
    vA, vB = cA.drift.verdict.tolist(), cB.drift.verdict.tolist()
    names = engine.VERDICT_NAMES
    rows = []
    for i, j in enumerate(jobs):
        rows.append(dict(
            i=i, scenario=j.scenario, topo_seed=j.topo_seed, seed=j.seed,
            lam=j.lam, frac=bounds[i][1], bound=bounds[i][0],
            in_order=names[vA[i]], summed_first=names[vB[i]],
            decided_at=[int(cA.drift.decided_at[i]),
                        int(cB.drift.decided_at[i])],
            margin=float(worst[i]), est_diff=float(dest[i]),
            max_dq=float(dq[i]), max_du=float(du[i])))
    split = [r for r in rows if r["in_order"] != r["summed_first"]]

    def tally(key):
        return {n: sum(r[key] == n for r in rows)
                for n in ("STABLE", "UNSTABLE", "UNDECIDED")}
    summary = dict(
        sims=len(rows), T=runner.T, chunk=runner.chunk, seconds=secs,
        in_order=tally("in_order"), summed_first=tally("summed_first"),
        split=len(split),
        split_margin_max=max((r["margin"] for r in split), default=None),
        unsplit_margin_min=min(r["margin"] for r in rows
                               if r not in split),
        est_diff_max=max(r["est_diff"] for r in rows),
        diverged=sum(r["max_dq"] > 1e-3 for r in rows),
        diverged_split=sum(r["max_dq"] > 1e-3 for r in split))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(summary=summary, sims=rows), indent=1))
    print(json.dumps(summary))
    for r in split:
        print(json.dumps(r))


def jax_regulator_bits(jax, seed, T, NC, eps):
    """The reference runner's regulator draws:
    bernoulli(split(fold_in(PRNGKey(seed), t), 3)[2], eps, (NC,))."""
    key = jax.random.PRNGKey(seed)

    def bits(t):
        k = jax.random.split(jax.random.fold_in(key, t), 3)[2]
        return jax.random.bernoulli(k, eps, (NC,))
    return np.asarray(jax.jit(jax.vmap(bits))(jax.numpy.arange(T)),
                      np.float32)


def cmd_reference(args):
    import jax
    from repro import fleet as jfleet
    from repro.core.policies import PolicyConfig as JConfig
    data = json.loads(pathlib.Path(args.split).read_text())
    T, chunk = data["summary"]["T"], data["summary"]["chunk"]
    smoke = load_smoke()
    jobs, _ = smoke.main_jobs()
    quiet = [r for r in data["sims"]
             if get_scenario(r["scenario"]).events in NOISE_FREE_EVENTS]
    split = [r for r in quiet if r["in_order"] != r["summed_first"]]
    rest = sorted((r for r in quiet if r not in split),
                  key=lambda r: r["margin"])[:args.extra]
    picked = split + rest
    if not picked:
        print(json.dumps(dict(compared=0)))
        return
    sub = [jobs[r["i"]] for r in picked]
    rng = np.random.default_rng(args.seed)
    trace = np.stack([rng.poisson(j.lam, T).astype(np.float32)
                      for j in sub])
    dims = engine.PadDims(smoke.N_MAIN, smoke.E_MAIN, smoke.NC_MAIN)
    reg = np.zeros((len(sub), T, dims.n_comp), np.float32)
    want = []
    for b, j in enumerate(sub):
        p = jfleet.get_scenario(j.scenario).build(j.topo_seed)
        reg[b, :, :p.n_comp] = jax_regulator_bits(jax, j.seed, T, p.n_comp,
                                                  j.eps_b)
        out = jfleet.stream_simulate(
            p, JConfig(name="pi3_reg", eps_b=j.eps_b), j.lam, T,
            chunk=chunk, seed=j.seed, arrivals=jax.numpy.asarray(trace[b]),
            dims=jfleet.PadDims(dims.n_nodes, dims.n_edges, dims.n_comp))
        want.append((int(out["verdict"]), int(out["decided_at_slot"])))
    inp = batch_of(sub, dims)
    runner = engine.make_stream_runner(PolicyConfig("pi3_reg",
                                                    eps_b=smoke.EPS_B),
                                       T=T, chunk=chunk)
    torch.set_grad_enabled(False)
    cA, cB, worst, dest, dq, _ = lockstep(
        runner, inp, torch.from_numpy(trace), torch.from_numpy(reg),
        early_stop=False)
    names = engine.VERDICT_NAMES
    rows = []
    for b, r in enumerate(picked):
        rows.append(dict(
            i=r["i"], scenario=r["scenario"], frac=r["frac"],
            split_on_port_noise=r in split,
            reference=[names[want[b][0]], want[b][1]],
            in_order=[names[int(cA.drift.verdict[b])],
                      int(cA.drift.decided_at[b])],
            summed_first=[names[int(cB.drift.verdict[b])],
                          int(cB.drift.decided_at[b])],
            margin=float(worst[b]), est_diff=float(dest[b]),
            max_dq=float(dq[b])))
    agree = {k: sum(x[k][0] == x["reference"][0] for x in rows)
             for k in ("in_order", "summed_first")}
    summary = dict(compared=len(rows), split_sims=len(split),
                   extra=len(rest), T=T, chunk=chunk,
                   agree_with_reference=agree,
                   orders_split=sum(x["in_order"][0] != x["summed_first"][0]
                                    for x in rows))
    print(json.dumps(summary))
    for x in rows:
        print(json.dumps(x))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("split")
    s.add_argument("--out", default="build/verdict_split.json")
    s.add_argument("--T", type=int, default=4096)
    s.add_argument("--chunk", type=int, default=512)
    s.add_argument("--limit", type=int, default=0,
                   help="run every n-th job only, this many (0: all)")
    r = sub.add_parser("reference")
    r.add_argument("--split", default="build/verdict_split.json")
    r.add_argument("--extra", type=int, default=24)
    r.add_argument("--seed", type=int, default=21)
    args = ap.parse_args(argv)
    {"split": cmd_split, "reference": cmd_reference}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
