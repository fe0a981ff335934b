"""The least work of one launch of the fused slot-step kernel
(`bp_slot_step_kernel`), from its shapes alone: every input read once and
every output written once, per lane

  * state in and out: Q [N, 3, NC], Ddum [N, NC], X and cum_arr [NC, 2],
    Y, H and cum_comb [NC], four delivery counters, float32;
  * problem: edges [E, 2] int32, edge_cap and edge_mask [E] float32,
    s1, s2, dest int32, comp_nodes int32, comp_caps and comp_mask [NC]
    float32, sink [N, 3, NC] bool;
  * per-slot inputs: arrivals, eps_b float32, and the regulator's bits
    [NC] float32 when the policy is regulated;
  * metrics out: total_queue, routed, computed float32, Z [NC] float32,
    n_star int32.

A problem that every lane shares (the trace simulator repeats one problem
over its rates without copying it) is read once per launch.

Operations: the routing differential over every link and class (subtract,
absolute value, compare: 3 E C), a few dozen per link and per comp node
around it, and the sum over the state for the backlog.  They are far below
the bytes' time on any card, so the bound is the bytes'.
"""
from __future__ import annotations

F32 = I32 = 4


def bytes_moved(B: int, N: int, E: int, NC: int, regulated: bool,
                shared_problem: bool = False) -> int:
    state = (N * 3 * NC + N * NC + 2 * NC * 2 + 3 * NC + 4) * F32
    problem = (E * 2 * I32 + 2 * E * F32 + 3 * I32 + NC * I32 + 2 * NC * F32
               + N * 3 * NC)
    inputs = 2 * F32 + (NC * F32 if regulated else 0)
    metrics = 3 * F32 + NC * F32 + I32
    return (B * (2 * state + inputs + metrics)
            + (1 if shared_problem else B) * problem)


def flops(B: int, N: int, E: int, NC: int, regulated: bool,
          shared_problem: bool = False) -> int:
    C = 3 * NC
    return B * (3 * E * C + 25 * E + 20 * NC + 2 * N * C)


def least_seconds(shapes: dict, peaks: dict) -> float:
    """The larger of bytes over the memory peak and operations over the
    float32 peak."""
    return max(bytes_moved(**shapes) / peaks["hbm_bytes_per_s"],
               flops(**shapes) / peaks["f32_flops_per_s"])
