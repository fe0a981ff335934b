#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It needs nothing but the checkout: the CUDA kernels are built from
`src/repro_torch/kernels/*/csrc/*.cu` with nvcc.  Phases, each of which
raises (and the script exits non-zero) on failure:

  1. device and build: the card, torch and CUDA versions, kernel build time;
  2. each kernel against its plain PyTorch version on the card at the main
     path's shapes (B=1512 sims, N=16, C=12, E=51, NC=4), random and
     tie-heavy inputs: outputs must be bit-identical; times with CUDA
     events beside each kernel's bound;
  3. the main path at full width: `run_fleet` over 1,512 pi3_reg sims (8
     registry families x topo_seeds 0-20 x 3 rates x 3 seeds, padded to the
     atlas hull (16, 51, 4)), T=4096, chunk=512, early stop; results are
     held to the exact LP bound, and the kernels' launch counters to the
     slots advanced; a profiler trace counts CUDA launches per slot;
  4. determinism and lane independence: a 64-sim subset twice, and one job
     alone, must give bit-identical metrics; and the card against the
     port's plain path on the CPU, all 1,512 sims for 256 slots from one
     random state with the same counter-based noise: stepped from the same
     carry each slot, the two agree to rounding (see `phase_reference`);
  5. a short wireless_grid run, so the greedy-matching branch runs.

The second-to-last lines are the kernel table (one JSON object) and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_MAIN, N_MAIN, C_MAIN, E_MAIN, NC_MAIN = 1512, 16, 12, 51, 4
FAMILIES = ("paper_grid", "random_geometric", "ring", "tree", "expander",
            "fat_tree", "ge_grid", "ge_comp_grid")
RATE_FRACS = (0.5, 0.95, 1.3)
SEEDS = (0, 1, 2)
TOPO_SEEDS = tuple(range(21))
EPS_B = 0.05
T_MAIN, CHUNK_MAIN = 4096, 512
LP_TOL = 1.02            # windowed rates may exceed the bound by drain noise
#: comp_balance_decide panels that each pairing does not read (bp_slot.cu).
BALANCE_UNREAD = {"fifo": ("x_net",), "bound": ("ca1", "ca2", "cc")}
REF_SLOTS = 256          # slots of the card-vs-CPU comparison (phase 4)

#: Published peaks of the H100 SXM (NVIDIA's data sheet, at 700 W): memory
#: bytes/s and float32 operations/s outside the tensor cores.  The bounds
#: are stated for this card only.
H100_SXM_PEAKS = (3.35e12, 67e12)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


def card_peaks(name: str):
    """The peaks the bounds use; another card's are not in this script."""
    check("H100" in name and "PCIe" not in name and "NVL" not in name,
          f"bounds are stated for the H100 SXM only; add the peaks of "
          f"{name!r} before measuring on it")
    return H100_SXM_PEAKS


def device_ms(fn, match: str | None = None, n: int = 60,
              warm: int = 10) -> float:
    """Median device time of one call of ``fn``: the durations of the CUDA
    activities a profiler trace records for each of ``n`` calls after a
    warm-up (only those whose name contains ``match``, when given).  Host
    overhead between launches is excluded: this is the card's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and (match is None or match in e.name)]
    check(len(evs) >= n, f"profiler saw {len(evs)} device activities for "
          f"{n} calls")
    if len(evs) % n:                     # calls differ: report the mean
        return sum(e.device_time for e in evs) / n / 1e3
    k = len(evs) // n
    evs.sort(key=lambda e: e.time_range.start)
    per_call = [sum(e.device_time for e in evs[i * k:(i + 1) * k])
                for i in range(n)]
    return statistics.median(per_call) / 1e3


def wall_ms(fn, n: int = 60, warm: int = 10) -> float:
    """Median time of one call between CUDA events recorded around it on
    the host's stream: includes the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def route_inputs(gen, ties: bool, dev):
    import torch
    B, N, C, E = B_MAIN, N_MAIN, C_MAIN, E_MAIN
    if ties:
        base = torch.randint(0, 4, (B, N, C // 3), generator=gen).float()
        Qf = base.repeat(1, 1, 3)                    # duplicated columns
        Qf[:, 1] = 0.0                               # an all-zero row
    else:
        Qf = torch.rand((B, N, C), generator=gen) * 100
    m = torch.randint(0, N, (B, E), generator=gen)
    l = (m + 1 + torch.randint(0, N - 1, (B, E), generator=gen)) % N
    m[:, -3:] = 0                                    # padded self-loops
    l[:, -3:] = 0
    if ties:
        m[:, 0] = 1
        l[:, 0] = 1
    return (Qf.contiguous().to(dev), m.to(torch.int32).to(dev),
            l.to(torch.int32).to(dev))


def balance_inputs(gen, ties: bool, dev):
    import torch
    B, NC = B_MAIN, NC_MAIN

    def r(lo, hi):
        if ties:
            return torch.randint(int(lo), int(hi) + 1, (B, NC),
                                 generator=gen).float()
        return lo + torch.rand((B, NC), generator=gen) * (hi - lo)
    from repro_torch.kernels.bp_slot.ref import PANELS
    p = dict(q0=r(0, 10), q1=r(0, 10), q2=r(0, 10), H=r(0, 10),
             caps=r(1, 3), x1=r(0, 10), x2=r(0, 10), ca1=r(5, 20),
             ca2=r(5, 20), cc=r(0, 5), x_net=r(0, 10))
    p["mask"] = (torch.rand((B, NC), generator=gen) > 0.3).float()
    p["mask"][:16] = 0.0                             # all-masked sims
    p["mask"][16:32] = 1.0
    eps = torch.tensor([0.0, 0.01, 0.05, 0.3])[
        torch.randint(0, 4, (B,), generator=gen)]
    return [eps.to(dev)] + [p[k].contiguous().to(dev) for k in PANELS]


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def phase_kernels(dev, peaks):
    import torch
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.kernels.bp_slot import ref as R
    mem_rate, f32_rate = peaks
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # slot_route_decide
    errs, timing = [], None
    for ties in (False, True):
        Qf, m, l = route_inputs(gen, ties, dev)
        best, dmax = K.slot_route_decide(Qf, m, l)
        rbest, rdmax = R.slot_route_ref(Qf, m, l)
        torch.cuda.synchronize()
        check(bits_equal(best, rbest) and bits_equal(dmax, rdmax),
              f"slot_route_decide differs from its plain version "
              f"(ties={ties})")
        if ties:
            check(bool((best[:, 0] == 0).all()), "zero row must pick 0")
        check(bool((best[:, -3:] == 0).all() and (dmax[:, -3:] == 0).all()),
              "padded self-loops must pick class 0 with zero diff")
        errs += [(best, rbest), (dmax, rdmax)]
        if not ties:
            timing = (Qf, m, l)
    Qf, m, l = timing
    B, N, C = Qf.shape
    E = m.shape[1]
    # Bytes the function needs: the Qf rows some edge reads (counted on
    # this run's indices), both index arrays, and both outputs.
    read = torch.cat([m, l], 1).long() + \
        torch.arange(B, device=dev)[:, None] * N
    n_rows = int(read.unique().numel())
    nbytes = 4 * n_rows * C + 2 * 4 * B * E + (4 + 4) * B * E
    nops = 3 * B * E * C                 # subtract, |.|, compare per class
    rows["slot_route_decide"] = dict(
        name="slot_route_decide", route="cuda",
        source="src/repro_torch/kernels/bp_slot/csrc/bp_slot.cu",
        replaces="src/repro/kernels/bp_slot/kernel.py:59",
        max_abs_err=max_abs_err(errs),
        ms=device_ms(lambda: K.slot_route_decide(Qf, m, l),
                     match="slot_route_decide_kernel"),
        wrapper_ms=device_ms(lambda: K.slot_route_decide(Qf, m, l)),
        wall_ms=wall_ms(lambda: K.slot_route_decide(Qf, m, l)),
        plain_ms=device_ms(lambda: R.slot_route_ref(Qf, m, l)),
        bound_ms=max(nbytes / mem_rate, nops / f32_rate) * 1e3,
        bound_by="bytes" if nbytes / mem_rate >= nops / f32_rate
        else "operations",
        library_ms=None, bytes=nbytes, ops=nops)

    # comp_balance_decide
    errs, timing = [], None
    for ties in (False, True):
        args = balance_inputs(gen, ties, dev)
        for pairing in ("fifo", "bound"):
            for thresholded in (False, True):
                kw = dict(pairing=pairing, thresholded=thresholded,
                          threshold=3.0)
                Z, n = K.comp_balance_decide(*args, **kw)
                rZ, rn = R.comp_balance_ref(*args, **kw)
                torch.cuda.synchronize()
                check(bits_equal(Z, rZ) and bits_equal(n, rn),
                      f"comp_balance_decide differs from its plain version "
                      f"(ties={ties}, {kw})")
                check(bool((n[:16] == 0).all()), "all-masked sims must give 0")
                errs += [(Z, rZ), (n, rn)]
        if not ties:
            timing = args
    args = timing
    NC = args[1].shape[1]
    # Timed as the main path calls it (pi3_reg: fifo pairing, no gate).
    # Bytes: eps, the panels this pairing reads, Z and n*.
    kw = dict(pairing="fifo", thresholded=False, threshold=0.0)
    n_panels = len(R.PANELS) - len(BALANCE_UNREAD[kw["pairing"]])
    nbytes = 4 * B * (1 + n_panels * NC) + 4 * B * NC + 4 * B
    nops = 16 * B * NC                   # pairs, clip, gate, score, fold
    rows["comp_balance_decide"] = dict(
        name="comp_balance_decide", route="cuda",
        source="src/repro_torch/kernels/bp_slot/csrc/bp_slot.cu",
        replaces="src/repro/kernels/bp_slot/kernel.py:138",
        max_abs_err=max_abs_err(errs),
        ms=device_ms(lambda: K.comp_balance_decide(*args, **kw),
                     match="comp_balance_decide_kernel"),
        wrapper_ms=device_ms(lambda: K.comp_balance_decide(*args, **kw)),
        wall_ms=wall_ms(lambda: K.comp_balance_decide(*args, **kw)),
        plain_ms=device_ms(lambda: R.comp_balance_ref(*args, **kw)),
        bound_ms=max(nbytes / mem_rate, nops / f32_rate) * 1e3,
        bound_by="bytes" if nbytes / mem_rate >= nops / f32_rate
        else "operations",
        library_ms=None, bytes=nbytes, ops=nops)
    for r in rows.values():
        log(f"kernel {r['name']}: {r['ms']:.6f} ms on the card (wrapper "
            f"{r['wrapper_ms']:.6f} ms of device time, {r['wall_ms']:.6f} ms "
            f"between host events; plain {r['plain_ms']:.6f} ms on the card"
            f"), bound {r['bound_ms'] * 1e3:.4f} us by {r['bound_by']} "
            f"({r['bytes']} B, {r['ops']} ops), max_abs_err "
            f"{r['max_abs_err']}, library: no single PyTorch call")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------

def main_jobs():
    from repro_torch.fleet import FleetJob, policy_bound_exact
    jobs, bounds = [], []
    for fam in FAMILIES:
        for ts in TOPO_SEEDS:
            bound = policy_bound_exact(fam, "pi3_reg", EPS_B, topo_seed=ts)
            for frac in RATE_FRACS:
                for seed in SEEDS:
                    jobs.append(FleetJob(scenario=fam, policy="pi3_reg",
                                         lam=frac * bound, seed=seed,
                                         topo_seed=ts, eps_b=EPS_B))
                    bounds.append((bound, frac))
    return jobs, bounds


def phase_main(dev):
    import numpy as np
    import torch
    from repro_torch.fleet import PadDims, run_fleet
    from repro_torch.kernels.bp_slot import kernel as K
    t0 = time.perf_counter()
    jobs, bounds = main_jobs()
    log(f"main: {len(jobs)} jobs, exact LP bounds in "
        f"{time.perf_counter() - t0:.1f} s")
    check(len(jobs) == B_MAIN, f"expected {B_MAIN} jobs, got {len(jobs)}")
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    K.slot_route_decide.launches = 0
    K.comp_balance_decide.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fleet(jobs, T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims,
                    early_stop=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"slot_route_decide": K.slot_route_decide.launches,
                "comp_balance_decide": K.comp_balance_decide.launches}
    check(res.n_programs == 1, "one policy group expected")
    check(launches["slot_route_decide"] == res.slot_steps > 0,
          f"route launches {launches} != slots advanced {res.slot_steps}")
    check(launches["comp_balance_decide"] == 2 * res.slot_steps,
          f"comp-balance launches {launches} != 2 x {res.slot_steps}")
    useful = res.column("useful_rate")
    check(bool(np.isfinite(useful).all() and
               np.isfinite(res.column("mean_queue")).all()),
          "non-finite metrics")
    bound = np.array([b for b, _ in bounds])
    frac = np.array([f for _, f in bounds])
    over = useful > LP_TOL * bound
    worst = [(jobs[i].scenario, jobs[i].topo_seed, useful[i], bound[i])
             for i in np.flatnonzero(over)[:5]]
    check(not over.any(),
          f"{int(over.sum())} sims above {LP_TOL} x bound: {worst}")
    verdicts = res.verdicts()
    pg = [i for i, j in enumerate(jobs)
          if j.scenario == "paper_grid" and frac[i] == 0.95]
    eff = float(np.median(useful[pg] / bound[pg]))
    check(eff >= 0.9, f"paper_grid median efficiency at 0.95x is {eff}")
    stable_over = [i for i in range(len(jobs))
                   if frac[i] == 1.3 and verdicts[i] == "STABLE"]
    check(not stable_over, f"{len(stable_over)} sims at 1.3x read STABLE")
    counts = {v: verdicts.count(v) for v in ("STABLE", "UNSTABLE",
                                             "UNDECIDED")}
    sim_slots = res.slot_steps * len(jobs)
    log(f"main: {len(jobs)} sims, T={res.T}, chunk={CHUNK_MAIN}, dims "
        f"{dims}, {res.slot_steps} slots advanced, wall {wall:.3f} s, "
        f"{wall / sim_slots * 1e6:.4f} us per sim-slot, "
        f"{wall / res.slot_steps * 1e3:.4f} ms per batched slot, "
        f"verdicts {counts}, slots_saved {res.slots_saved}, "
        f"paper_grid eff@0.95 {eff:.4f}, launches {launches}")
    by_family = {}
    for fam in FAMILIES:
        for f in RATE_FRACS:
            idx = [i for i, j in enumerate(jobs)
                   if j.scenario == fam and frac[i] == f]
            by_family[f"{fam}@{f}"] = round(float(np.median(
                useful[idx] / bound[idx])), 4)
    log("main: median efficiency by family@rate " + json.dumps(by_family))
    return res, jobs, launches, wall


def main_batch(dev):
    """The main path's 1,512 jobs as one padded batch and its run inputs."""
    from repro_torch.fleet import PadDims, engine
    from repro_torch.fleet.batching import from_leaves, pad_leaves
    from repro_torch.fleet.scenarios import arrival_code, event_code, \
        get_scenario
    jobs, _ = main_jobs()
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    leaves = {}
    for j in jobs:
        k = (j.scenario, j.topo_seed)
        if k not in leaves:
            leaves[k] = pad_leaves(get_scenario(j.scenario).build(
                j.topo_seed), dims)
    pp = from_leaves([leaves[(j.scenario, j.topo_seed)] for j in jobs],
                     dims.n_nodes, dims.n_comp, dev)
    return jobs, engine.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [arrival_code(get_scenario(j.scenario).arrival) for j in jobs],
        [event_code(get_scenario(j.scenario).events) for j in jobs],
        [j.seed for j in jobs])


def phase_profile(dev, wall_per_slot_ms: float):
    """CUDA activities per slot and the device's busy time per slot, from
    a profiler trace of one 64-slot chunk at full width."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.fleet import engine
    jobs, inp = main_batch(dev)
    pp = inp.pp
    runner = engine.make_stream_runner(PolicyConfig(name="pi3_reg",
                                                    eps_b=EPS_B),
                                       T=64, chunk=64,
                                       verdict=engine.resolve_verdict(
                                           None, True))
    carry = runner.init_carry(pp)
    runner.advance(inp, carry)                          # warm-up slot
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.chunk_step(inp, carry)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log("profile: not measured (the profiler recorded no device "
            "activity)")
        return None
    per_slot = len(dev_events) / runner.chunk
    dev_us = sum(e.device_time for e in dev_events) / runner.chunk
    kinds = {}
    for e in dev_events:
        kinds[e.name] = kinds.get(e.name, 0) + 1
    top = sorted(kinds.items(), key=lambda kv: -kv[1])[:12]
    idle = 1.0 - dev_us / 1e3 / wall_per_slot_ms
    log(f"profile: {per_slot:.2f} CUDA device activities per slot "
        f"(kernels, copies and memsets), {dev_us:.2f} us of device time per "
        f"slot at B={len(jobs)}; against the main run's "
        f"{wall_per_slot_ms:.4f} ms per slot the device is idle "
        f"{idle:.4f} of the time; most frequent: "
        + "; ".join(f"{n[:60]} x{c / runner.chunk:.2f}" for n, c in top))
    return per_slot


# ---------------------------------------------------------------------------
# Phase 4: determinism and lane independence; Phase 5: wireless
# ---------------------------------------------------------------------------

def phase_determinism(dev, main_res, jobs):
    from repro_torch.fleet import PadDims, run_fleet
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    picks = list(range(0, len(jobs), len(jobs) // 64))[:64]
    sub = [jobs[i] for i in picks]
    kw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims,
              early_stop=True)
    a = run_fleet(sub, **kw)
    b = run_fleet(sub, **kw)
    check(a.metrics == b.metrics, "a repeated 64-sim run differs")
    k = 37
    alone = run_fleet([sub[k]], **kw)
    check(alone.metrics[0] == a.metrics[k],
          f"job {sub[k]} alone differs from the same job in a batch of 64: "
          f"{alone.metrics[0]} vs {a.metrics[k]}")
    same_main = sum(a.metrics[i] == main_res.metrics[p]
                    for i, p in enumerate(picks))
    check(same_main == len(picks),
          f"only {same_main}/{len(picks)} subset sims equal their lane in "
          f"the 1,512-sim run")
    log(f"determinism: 64-sim subset repeated bit-identical; one job alone "
        f"== in batch of 64; {same_main}/64 equal to the 1,512-sim run")



def on_device(x, dev):
    """A copy of a tree of frozen dataclasses with every tensor on ``dev``."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: on_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


#: Kahan compensation leaf -> the running sum it compensates.
COMPENSATION = {"c_queue": "sum_queue", "c_q3": "sum_queue_q3",
                "c_q4": "sum_queue_q4", "delivered_c": "delivered",
                "delivered_useful_c": "delivered_useful"}
#: NetState leaves whose largest magnitude sets a sim's rounding scale.
SCALE_LEAVES = ("Q", "Ddum", "X", "Y", "H", "cum_arr", "cum_comb",
                "delivered", "delivered_useful")


def named_leaves(x, name: str = "") -> dict:
    """The tensors of a tree of dataclasses by field name (the names of a
    runner's carry are unique)."""
    import dataclasses
    if not dataclasses.is_dataclass(x):
        return {name: x}
    out = {}
    for f in dataclasses.fields(x):
        out.update(named_leaves(getattr(x, f.name), f.name))
    return out


def carry_diff(a, b):
    """How far carry ``a`` lies from carry ``b``, leaf by leaf.

    A float leaf's difference is taken over the magnitude it was computed
    at: the larger of its own and the sim's largest state value (at least
    1), since the pairs P = min(cum_arr) - cum_comb round at the scale of
    the cumulative counters.  A Kahan sum is compared as its compensated
    value (sum - c); the compensation term alone is a rounding residue and
    takes whatever value the rounding left.  Returns ({leaf: scaled
    difference}, {leaf: plain difference, relative or absolute below 1, of
    every raw leaf}, whether every non-float leaf is equal)."""
    import torch
    xa, xb = named_leaves(on_device(a, "cpu")), named_leaves(b)
    B = b.t.shape[0]
    scale = torch.stack([xb[k].reshape(B, -1).abs().amax(1)
                         for k in SCALE_LEAVES]).amax(0).double().clamp(min=1)
    sums = {v: k for k, v in COMPENSATION.items()}
    scaled, plain, same = {}, {}, True
    for k, y in xb.items():
        x = xa[k]
        if not y.dtype.is_floating_point:
            same = same and torch.equal(x, y)
            continue
        if y.numel() == 0:
            continue
        plain[k] = float(((x.double() - y.double()).abs()
                          / y.double().abs().clamp(min=1.0)).max())
        if k in COMPENSATION:
            continue
        x, y = x.double(), y.double()
        if k in sums:
            x = x - xa[sums[k]].double()
            y = y - xb[sums[k]].double()
        s = torch.maximum(y.abs(), scale.view(-1, *[1] * (y.dim() - 1)))
        scaled[k] = float(((x - y).abs() / s).max())
    return scaled, plain, same


def top(d: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:n])


def phase_reference(dev):
    """The card against the port's plain path on the CPU (the kernels'
    plain versions and in-order scatters), over REF_SLOTS slots of the
    runner for all 1,512 sims of the main batch, from one random state,
    with the engine's counter-based noise (the same on both devices).

    Teacher-forced: at every slot the card and the CPU step the same carry,
    the CPU's.  Their decisions then come from bit-identical inputs through
    bit-identical kernels (phase 2), so the two new carries may differ only
    by the rounding of sums that run in another order on the card (the
    sorted scatter-adds, the reductions): every non-float leaf equal, every
    float leaf within 1e-5 as `carry_diff` scales it, at every slot.

    Free-running: the card also steps its own carry alongside.  Reported,
    not gated: the first slot at which it parts from the CPU's by more than
    1e-3, and how far apart the two were the slot before.  Rounding-sized
    before and decision-sized after means that slot's flip was a near-tie
    met with rounding-different inputs, not different dynamics."""
    import numpy as np
    from repro_torch.convert import net_state_from_numpy
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.fleet import engine
    t0 = time.perf_counter()
    jobs, inp = main_batch("cpu")
    B, N, NC = len(jobs), N_MAIN, NC_MAIN
    rng = np.random.default_rng(0)
    Q = (rng.random((B, N, 3, NC)) * 6).astype(np.float32)
    Q[rng.random(Q.shape) < 0.3] = 0.0
    state0 = dict(
        Q=Q, Ddum=(Q[:, :, 0] * rng.random((B, N, NC)) * 0.5),
        X=rng.random((B, NC, 2)) * 4, Y=rng.random((B, NC)) * 2,
        H=rng.random((B, NC)) * 3, cum_arr=10 + rng.random((B, NC, 2)) * 5,
        cum_comb=rng.random((B, NC)) * 8, delivered=np.full(B, 50.0),
        delivered_useful=np.full(B, 45.0), delivered_c=np.zeros(B),
        delivered_useful_c=np.zeros(B))
    runner = engine.make_stream_runner(
        PolicyConfig(name="pi3_reg", eps_b=EPS_B), T=T_MAIN,
        chunk=CHUNK_MAIN, verdict=engine.resolve_verdict(None, True))
    carry = runner.init_carry(inp.pp)
    carry = engine.Carry(net_state_from_numpy(state0), carry.stats,
                         carry.drift, carry.mod, carry.t)
    inp_dev = on_device(inp, dev)
    free = on_device(carry, dev)
    worst_leaf, plain_leaf = {}, {}
    parted, before = None, 0.0
    for t in range(REF_SLOTS):
        forced = runner.slot(inp_dev, on_device(carry, dev))
        free = runner.slot(inp_dev, free)
        carry = runner.slot(inp, carry)
        scaled, plain, same = carry_diff(forced, carry)
        check(same and max(scaled.values()) <= 1e-5,
              f"slot {t}: card vs CPU from the same carry: non-float leaves "
              f"equal {same}; largest scaled differences {top(scaled)}; "
              f"plain {top(plain)}")
        for k, v in scaled.items():
            worst_leaf[k] = max(worst_leaf.get(k, 0.0), v)
        for k, v in plain.items():
            plain_leaf[k] = max(plain_leaf.get(k, 0.0), v)
        apart = max(carry_diff(free, carry)[0].values())
        if parted is None and apart > 1e-3:
            parted = (t, apart)
        elif parted is None:
            before = apart
    free_note = (f"parted at slot {parted[0]} by {parted[1]:.3e} after "
                 f"{before:.3e} the slot before" if parted else
                 f"within {before:.3e} of the CPU's throughout")
    log(f"reference: {REF_SLOTS} slots x {B} sims, card vs the port's CPU "
        f"path from one random state, {time.perf_counter() - t0:.1f} s: "
        f"teacher-forced, non-float leaves equal and scaled differences "
        f"at most {max(worst_leaf.values()):.3e} ({top(worst_leaf)}; "
        f"plain per-leaf differences {top(plain_leaf)}); free-running, "
        f"the card's carry {free_note}")


def phase_wireless(dev):
    import numpy as np
    from repro_torch.fleet import FleetJob, policy_bound_exact, run_fleet
    bound = policy_bound_exact("wireless_grid", "pi3", EPS_B)
    jobs = [FleetJob("wireless_grid", "pi3", lam=f * bound, seed=s,
                     eps_b=EPS_B) for f in (0.3, 0.6) for s in (0, 1, 2)]
    res = run_fleet(jobs, T=512, chunk=128, device=dev)
    useful = res.column("useful_rate")
    check(bool(np.isfinite(useful).all()), "wireless: non-finite metrics")
    check(bool((useful <= LP_TOL * bound).all()),
          f"wireless: useful {useful} above bound {bound}")
    check(bool((res.column("delivered_useful") > 0).all()),
          "wireless: nothing delivered")
    log(f"wireless: 6 sims x 512 slots, useful rates {np.round(useful, 3)} "
        f"vs bound {bound:.3f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    peaks = card_peaks(name)
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; bounds use the H100 SXM peaks "
        f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"build: {len(_build.sources())} source(s) with nvcc in {secs:.2f} s")

    rows = phase_kernels(dev, peaks)
    res, jobs, launches, wall = phase_main(dev)
    for k, r in rows.items():
        r["launches"] = launches[k]
    phase_profile(dev, wall / res.slot_steps * 1e3)
    phase_reference(dev)
    phase_determinism(dev, res, jobs)
    phase_wireless(dev)
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = {"kernels": [{k: r[k] for k in keys} for r in rows.values()]}
    for r in table["kernels"]:
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            check(math.isfinite(r[k]), f"{r['name']}: {k} not finite")
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
