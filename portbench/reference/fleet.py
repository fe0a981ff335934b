"""The fleet engine's semantics in plain NumPy, lane by lane: arrivals,
capacity event models, the slot, the online metrics and the streaming
stability verdict, with decided lanes frozen (early stopping), and each
lane's final metrics.

Inputs are the benchmark's own: the frozen topologies of the
configuration, each lane's offered rate and seed.  Everything the program
derives from them (padded problem tensors, Poisson tables, the
counter-based noise) is worked out again here.

``carry`` is how the carry is held between slots: ``"float32"`` as the
deployment states, or ``"bfloat16"`` (every float leaf rounded to
bfloat16 after each slot, arithmetic in float32), the control: the
precision a later change that halves the state's bytes would tempt.
"""
from __future__ import annotations

import numpy as np
from scipy import stats

from . import noise, slot

F32 = np.float32

#: Truncation of the Poisson inverse-CDF rows (mass left beyond a row).
POISSON_TAIL = 1e-12
#: Queries per burst of Bernoulli-batch arrivals.
BURST = 4
#: Gilbert-Elliott link chains: P(Good->Bad), P(Bad->Good), Bad's scale.
GE_P_GB, GE_P_BG, GE_BAD_SCALE = 0.02, 0.20, 0.25
#: Gilbert-Elliott comp-node chains: P(Up->Down), P(Down->Up).
GE_COMP_P_UD, GE_COMP_P_DU = 0.01, 0.15
#: Streaming verdict: consecutive windows to latch, and the tolerances
#: (per slot, x max(lam, 1)) on drift and on the delivered-vs-offered gap.
K_STABLE = K_UNSTABLE = 3
DRIFT_TOL, GAP_TOL = 0.02, 0.05
UNDECIDED, STABLE, UNSTABLE = 0, 1, 2

ARRIVALS = ("poisson", "bernoulli_batch")
#: The load-balancing policies the reference implements, and whether each
#: pushes its output through the regulator.
POLICIES = {"pi3": True, "pi3_reg": True, "pi3bar": False}
EVENTS = ("static", "gilbert_elliott", "ge_comp")


def regulated(policy: str) -> bool:
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r} not in the reference")
    return POLICIES[policy]


def poisson_table(rates) -> np.ndarray:
    """[B, K] float64 rows cdf[b, k] = P(Poisson(rate[b]) <= k), each 1.0
    beyond its own width (the smallest count leaving < POISSON_TAIL)."""
    rates = np.asarray(rates, np.float64).reshape(-1)
    own = np.array([int(stats.poisson.isf(POISSON_TAIL, r)) + 2 if r > 0
                    else 1 for r in rates], np.int64)
    cols = np.arange(int(own.max()))[None, :]
    cdf = stats.poisson.cdf(cols, rates[:, None])
    cdf[(cols >= own[:, None]) | (rates[:, None] <= 0)] = 1.0
    return cdf


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


CARRY = {"float32": lambda x: x, "bfloat16": to_bfloat16}


def padded_problem(topos, pad: dict) -> dict:
    """The lanes' topologies embedded in the pad dims: padded links are
    (0, 0) with capacity 0 and mask 0, padded comp nodes node 0 with
    capacity 0 and mask 0."""
    N, E, NC = pad["n_nodes"], pad["n_edges"], pad["n_comp"]
    B = len(topos)
    p = {"edges": np.zeros((B, E, 2), np.int64),
         "edge_cap": np.zeros((B, E), F32), "edge_mask": np.zeros((B, E), F32),
         "comp_nodes": np.zeros((B, NC), np.int64),
         "comp_caps": np.zeros((B, NC), F32),
         "comp_mask": np.zeros((B, NC), F32),
         "sink": np.zeros((B, N, 3, NC), bool)}
    for k in ("s1", "s2", "dest"):
        p[k] = np.array([t[k] for t in topos], np.int64)
    p["wireless"] = np.array([bool(t["wireless"]) for t in topos])
    for b, t in enumerate(topos):
        e, nc = len(t["edges"]), len(t["comp_nodes"])
        p["edges"][b, :e] = t["edges"]
        p["edge_cap"][b, :e] = t["capacity"]
        p["edge_mask"][b, :e] = 1.0
        p["comp_nodes"][b, :nc] = t["comp_nodes"]
        p["comp_caps"][b, :nc] = t["comp_caps"]
        p["comp_mask"][b, :nc] = 1.0
        for j, n in enumerate(t["comp_nodes"]):
            p["sink"][b, n, 1, j] = p["sink"][b, n, 2, j] = True
            p["sink"][b, t["dest"], 0, j] = True
    return p


def _verdict(d, t1, tq, du, lam, window, burn_in):
    """The streaming verdict's update at the end of the slot whose count
    is ``t1`` (the same for every lane): anchor at the burn-in, then per
    window the anchored drift and useful rate as evidence."""
    anchor = t1 == burn_in
    counted = t1 % window == 0 and t1 >= burn_in + 2 * window
    d = dict(d)
    if anchor:
        d["q_mark"], d["useful_mark"] = tq.copy(), du.copy()
    if not counted:
        return d
    scale = np.maximum(lam, F32(1.0))
    elapsed = F32(max(t1 - burn_in, 1))
    drift = (tq - d["q_mark"]) / elapsed
    rate = (du - d["useful_mark"]) / elapsed
    gap = lam - rate
    stable_ev = (drift <= F32(DRIFT_TOL) * scale) & \
        (gap <= F32(GAP_TOL) * scale)
    unstable_ev = (drift >= F32(2.0 * DRIFT_TOL) * scale) & \
        (gap >= F32(GAP_TOL) * scale)
    s_run = np.where(stable_ev, d["stable_run"] + 1, 0)
    u_run = np.where(unstable_ev, d["unstable_run"] + 1, 0)
    newly = np.where(s_run >= K_STABLE, STABLE,
                     np.where(u_run >= K_UNSTABLE, UNSTABLE, UNDECIDED))
    decide = (d["verdict"] == UNDECIDED) & (newly != UNDECIDED)
    d.update(last_drift=drift, last_rate=rate, stable_run=s_run,
             unstable_run=u_run,
             verdict=np.where(decide, newly, d["verdict"]),
             decided_at=np.where(decide, t1, d["decided_at"]))
    return d


def run_lanes(topos, lams, seeds, *, pad: dict, eps_b: float, T: int,
              chunk: int, regulated: bool = True,
              carry: str = "float32") -> dict:
    """Every lane's final metrics after a run of ``T`` slots (rounded up to
    whole chunks) under early stopping: {metric: [B] float64}."""
    B = len(topos)
    N, E, NC = pad["n_nodes"], pad["n_edges"], pad["n_comp"]
    n_chunks = -(-T // chunk)
    T = n_chunks * chunk
    window, vwin = T // 2, chunk
    burn = 2 * vwin
    q3_lo, q4_lo = T // 2, (3 * T) // 4
    hold = CARRY[carry]
    p = padded_problem(topos, pad)
    lam = np.asarray(lams, F32)
    eps = np.full((B,), eps_b, F32)
    seeds = np.asarray(seeds, np.int64)
    for k in {t["events"] for t in topos} - set(EVENTS):
        raise ValueError(f"event model {k!r} not in the reference")
    for k in {t["arrival"] for t in topos} - set(ARRIVALS):
        raise ValueError(f"arrival model {k!r} not in the reference")
    bern = np.array([t["arrival"] == "bernoulli_batch" for t in topos])
    ge_link = np.array([t["events"] == "gilbert_elliott" for t in topos])
    ge_comp = np.array([t["events"] == "ge_comp" for t in topos])
    cdf = poisson_table(lam.astype(np.float64))
    burst_p = np.minimum(lam / F32(BURST), F32(1.0)).astype(np.float64)

    s = slot.zero_state(B, N, NC)
    z = np.zeros((B,), F32)
    acc = {k: z.copy() for k in ("sum_q", "c_q", "sum_q3", "c_q3", "sum_q4",
                                 "c_q4", "max_q", "useful_at_mark")}
    zi = np.zeros((B,), np.int64)
    d = {"q_mark": z.copy(), "useful_mark": z.copy(),
         "last_drift": z.copy(), "last_rate": z.copy(),
         "stable_run": zi.copy(), "unstable_run": zi.copy(),
         "verdict": zi.copy(), "decided_at": zi.copy()}
    link = np.ones((B, E), F32)
    comp_up = np.ones((B, NC), F32)
    # Early stopping freezes a lane's whole carry from the slot after its
    # verdict latches.  A verdict can latch only at the end of a verdict
    # window, where every undecided lane has run the same slots, so the
    # reference runs every lane on and keeps each lane's carry as it was at
    # the window end where it decided.
    final = {"s": dict(s), "acc": dict(acc), "d": dict(d), "t": zi.copy()}
    done = np.zeros((B,), bool)
    rng_t = np.arange(chunk)
    for c0 in range(0, T, chunk):
        if done.all():
            break
        tt = np.broadcast_to(c0 + rng_t[:, None], (chunk, B)).reshape(-1)
        ss = np.broadcast_to(seeds[None, :], (chunk, B)).reshape(-1)
        u_arr = noise.uniform64(ss, tt, noise.SITE_ARRIVAL, 1).reshape(
            chunk, B)
        u_link = noise.uniform(ss, tt, noise.SITE_EVENT_LINK, E).reshape(
            chunk, B, E)
        u_comp = noise.uniform(ss, tt, noise.SITE_EVENT_COMP, NC).reshape(
            chunk, B, NC)
        n_arr = np.where(bern[None, :], (u_arr < burst_p) * float(BURST),
                         (cdf[None, :, :] <= u_arr[..., None]).sum(2)
                         ).astype(F32)
        bits = (noise.uniform(ss, tt, noise.SITE_REGULATOR, NC).reshape(
            chunk, B, NC) < F32(eps_b)).astype(F32) if regulated else None
        for j in range(chunk):
            step = c0 + j
            good = np.where(link > 0.5, u_link[j] >= F32(GE_P_GB),
                            u_link[j] < F32(GE_P_BG)).astype(F32)
            up = np.where(comp_up > 0.5, u_comp[j] >= F32(GE_COMP_P_UD),
                          u_comp[j] < F32(GE_COMP_P_DU)).astype(F32)
            link = np.where(ge_link[:, None], good, link)
            comp_up = np.where(ge_comp[:, None], up, comp_up)
            es = np.where(ge_link[:, None],
                          F32(GE_BAD_SCALE) + F32(1.0 - GE_BAD_SCALE) * good,
                          F32(1.0))
            cs = np.where(ge_comp[:, None], up, F32(1.0))
            ps = {**p, "edge_cap": p["edge_cap"] * es,
                  "comp_caps": p["comp_caps"] * cs,
                  "comp_mask": p["comp_mask"] * (cs > 0.0)}
            s, m = slot.slot(ps, s, n_arr[j], None if bits is None
                             else bits[j], eps)
            s = {k: hold(v) for k, v in s.items()}
            tq, du = m["total_queue"], s["delivered_useful"]
            a = acc
            a["sum_q"], a["c_q"] = slot.kahan_add(a["sum_q"], a["c_q"], tq)
            a["sum_q3"], a["c_q3"] = slot.kahan_add(
                a["sum_q3"], a["c_q3"], tq * F32(q3_lo <= step < q4_lo))
            a["sum_q4"], a["c_q4"] = slot.kahan_add(
                a["sum_q4"], a["c_q4"], tq * F32(step >= q4_lo))
            a["max_q"] = np.maximum(a["max_q"], tq)
            if step == T - window - 1:
                a["useful_at_mark"] = du.copy()
            acc = {k: hold(v) for k, v in a.items()}
            if (step + 1) % vwin:
                continue
            d = _verdict(d, step + 1, tq, du, lam, vwin, burn)
            d = {k: hold(v) if v.dtype == F32 else v for k, v in d.items()}
            latched = (d["verdict"] != UNDECIDED) & ~done
            keep = (latched | ~done) if step == T - 1 else latched
            if keep.any():
                for part, src in (("s", s), ("acc", acc), ("d", d)):
                    for k, v in src.items():
                        k_ = keep.reshape(-1, *([1] * (v.ndim - 1)))
                        final[part][k] = np.where(k_, v, final[part][k])
                final["t"] = np.where(keep, step + 1, final["t"])
                done = done | latched

    s, acc, d, t = final["s"], final["acc"], final["d"], final["t"]
    decided = d["verdict"] != UNDECIDED
    decided_at = np.where(decided, d["decided_at"], T).astype(F32)
    mean_q3 = acc["sum_q3"] / F32(max(q4_lo - q3_lo, 1))
    mean_q4 = acc["sum_q4"] / F32(max(T - q4_lo, 1))
    stable = np.where(decided, d["verdict"] == STABLE,
                      mean_q4 <= F32(1.25) * mean_q3 + F32(5.0))
    useful = np.where(decided, d["last_rate"],
                      (s["delivered_useful"] - acc["useful_at_mark"])
                      / F32(window))
    out = {
        "useful_rate": useful,
        "delivered": s["delivered"],
        "delivered_useful": s["delivered_useful"],
        "mean_queue": acc["sum_q"] / np.maximum(t.astype(F32), F32(1.0)),
        "mean_queue_mid": mean_q3, "mean_queue_tail": mean_q4,
        "max_queue": acc["max_q"],
        "stable": stable, "verdict": d["verdict"],
        "decided_at_slot": decided_at,
        "slots_saved": np.where(decided, F32(T) - decided_at, F32(0.0)),
    }
    return {k: np.asarray(v, np.float64) for k, v in out.items()}
