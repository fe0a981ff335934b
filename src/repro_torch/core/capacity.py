"""Theorem 1 / Theorem 4 capacity upper bound via the multicommodity-flow LP.

The port's own copy of `repro.core.capacity` (numpy/scipy only), kept so
the port never imports the JAX package.

For computation nodes N_C we build 3*N_C unicast commodities:
  (1,n): s1 -> n   rate lam_n      (raw data of source 1)
  (2,n): s2 -> n   rate lam_n      (raw data of source 2)
  (0,n): n  -> d   rate lam_n      (processed results)
subject to per-edge shared capacity (paper eq. (1)/(5)), flow conservation
(4), positivity and no-outflow-at-destination (6), and lam_n <= C_n.
lambda* = max sum_n lam_n.  Solved exactly with scipy/HiGHS.

The LP also supports an output-rate multiplier `rho0` on commodity (0,n)
(rate rho0*lam_n) which models the dummy-packet overhead (1+eps_B) of
policies pi2/pi3 (Theorem 3/5).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linprog

from .graph import ComputeProblem


@dataclasses.dataclass(frozen=True)
class CapacityResult:
    lam_star: float                 # max total query rate
    lam_per_node: np.ndarray        # [N_C] optimal per-node shares
    flows: np.ndarray               # [2E, 3*N_C] optimal directed flows
    status: str

    def time_share(self) -> np.ndarray:
        tot = self.lam_per_node.sum()
        return self.lam_per_node / max(tot, 1e-12)


def _commodity_endpoints(problem: ComputeProblem) -> list[tuple[int, int]]:
    """(src, dst) per commodity; order: for each n: (1,n), (2,n), (0,n)."""
    eps = []
    for n in problem.comp_nodes:
        eps.append((problem.s1, n))
        eps.append((problem.s2, n))
        eps.append((n, problem.dest))
    return eps


def capacity_upper_bound(problem: ComputeProblem, rho0: float = 1.0) -> CapacityResult:
    g = problem.graph
    NC = problem.n_comp
    E = g.n_edges
    de = g.directed_edges()           # [2E, 2]
    n_comm = 3 * NC
    nf = 2 * E * n_comm               # flow variables, layout f[dir_edge, comm]
    nv = nf + NC                      # + lam_n variables

    def fidx(dir_e: int, c: int) -> int:
        return dir_e * n_comm + c

    endpoints = _commodity_endpoints(problem)
    # rate multiplier per commodity (raw commodities 1, processed rho0)
    rate_mult = np.array([1.0, 1.0, rho0] * NC)

    # --- equality: flow conservation at every node, per commodity, except at
    # the commodity destination (conservation there is implied / slack-free
    # because we also force zero outflow at the destination).
    A_eq_rows, b_eq = [], []
    for c, (src, dst) in enumerate(endpoints):
        n_of_c = c // 3
        for m in range(g.n_nodes):
            if m == dst:
                continue
            row = np.zeros(nv)
            for e_id, (a, b) in enumerate(de):
                if a == m:
                    row[fidx(e_id, c)] += 1.0    # outgoing
                elif b == m:
                    row[fidx(e_id, c)] -= 1.0    # incoming
            if m == src:
                row[nf + n_of_c] = -rate_mult[c]
            A_eq_rows.append(row)
            b_eq.append(0.0)
    A_eq = np.array(A_eq_rows)
    b_eq = np.array(b_eq)

    # --- inequality: shared undirected edge capacity over all commodities+dirs
    A_ub_rows, b_ub = [], []
    for e in range(E):
        row = np.zeros(nv)
        for c in range(n_comm):
            row[fidx(e, c)] = 1.0
            row[fidx(e + E, c)] = 1.0
        A_ub_rows.append(row)
        b_ub.append(g.capacity[e])
    A_ub = np.array(A_ub_rows)
    b_ub = np.array(b_ub)

    # --- bounds: f >= 0; zero outflow at each commodity's destination (6);
    # 0 <= lam_n <= C_n.
    bounds = [(0.0, None)] * nv
    for c, (_, dst) in enumerate(endpoints):
        for e_id, (a, _) in enumerate(de):
            if a == dst:
                bounds[fidx(e_id, c)] = (0.0, 0.0)
    for i, cap in enumerate(problem.comp_caps):
        bounds[nf + i] = (0.0, float(cap))

    cobj = np.zeros(nv)
    cobj[nf:] = -1.0                 # maximize sum lam_n
    res = linprog(cobj, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    if not res.success:
        return CapacityResult(0.0, np.zeros(NC), np.zeros((2 * E, n_comm)),
                              status=res.message)
    lam_per_node = res.x[nf:]
    flows = res.x[:nf].reshape(2 * E, n_comm)
    return CapacityResult(float(lam_per_node.sum()), lam_per_node, flows, "optimal")


def single_node_capacity(problem: ComputeProblem, node_index: int,
                         rho0: float = 1.0) -> CapacityResult:
    """Theorem 1: capacity when computation is pinned to one node."""
    sub = dataclasses.replace(
        problem,
        comp_nodes=(problem.comp_nodes[node_index],),
        comp_caps=(problem.comp_caps[node_index],),
    )
    return capacity_upper_bound(sub, rho0=rho0)


# ---------------------------------------------------------------------------
# Multi-stream (multiclass) extension — the generalization the paper names
# in §II-B/§VI: multiple query streams, each with its own sources and
# destination, sharing links AND computation-node capacity.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiStreamResult:
    lam_star: float                 # max total rate at the given mix
    lam_per_stream: np.ndarray      # [n_streams]
    lam_per_node: np.ndarray        # [n_streams, N_C]
    status: str


def multi_stream_capacity(problems: list[ComputeProblem],
                          weights: list[float] | None = None,
                          rho0: float = 1.0) -> MultiStreamResult:
    """Max-weighted-throughput LP for several query streams on one graph.

    Streams sigma share (i) every edge capacity and (ii) the computation
    capacity C_n of every node that appears in more than one stream's N_C.
    With `weights` w (sum 1), we maximize lambda s.t. stream sigma gets
    rate w_sigma * lambda — the boundary point of the multiclass capacity
    region along direction w (paper's time-share view, eq. after Thm 4).
    """
    g = problems[0].graph
    for p in problems[1:]:
        assert p.graph.n_nodes == g.n_nodes and \
            (p.graph.edges == g.edges).all(), "streams must share the graph"
    NS = len(problems)
    weights = np.full(NS, 1.0 / NS) if weights is None else \
        np.asarray(weights, dtype=np.float64)
    assert abs(weights.sum() - 1.0) < 1e-9 and (weights > 0).all()

    E = g.n_edges
    de = g.directed_edges()
    # commodity layout: for each stream sigma, for each of its comp nodes:
    # (1,n), (2,n), (0,n); plus lam^sigma_n variables and one global lam.
    comm_of = []                      # (stream, endpoints, rate_var_index)
    lam_var_of = []                   # [(stream, node_idx)]
    for s_i, p in enumerate(problems):
        for n_i, n in enumerate(p.comp_nodes):
            lam_var_of.append((s_i, n_i))
    n_lam = len(lam_var_of)
    lam_index = {sn: i for i, sn in enumerate(lam_var_of)}

    rate_mult = []
    for s_i, p in enumerate(problems):
        for n_i, n in enumerate(p.comp_nodes):
            li = lam_index[(s_i, n_i)]
            comm_of.append((s_i, (p.s1, n), li, 1.0))
            comm_of.append((s_i, (p.s2, n), li, 1.0))
            comm_of.append((s_i, (n, p.dest), li, rho0))
    n_comm = len(comm_of)
    nf = 2 * E * n_comm
    nv = nf + n_lam + 1               # + global lam (last)

    def fidx(dir_e, c):
        return dir_e * n_comm + c

    A_eq_rows, b_eq = [], []
    for c, (s_i, (src, dst), li, mult) in enumerate(comm_of):
        for m in range(g.n_nodes):
            if m == dst:
                continue
            row = np.zeros(nv)
            for e_id, (a, b) in enumerate(de):
                if a == m:
                    row[fidx(e_id, c)] += 1.0
                elif b == m:
                    row[fidx(e_id, c)] -= 1.0
            if m == src:
                row[nf + li] = -mult
            A_eq_rows.append(row)
            b_eq.append(0.0)
    # per-stream total: sum_n lam^sigma_n = w_sigma * lam
    for s_i, p in enumerate(problems):
        row = np.zeros(nv)
        for n_i in range(p.n_comp):
            row[nf + lam_index[(s_i, n_i)]] = 1.0
        row[-1] = -weights[s_i]
        A_eq_rows.append(row)
        b_eq.append(0.0)

    A_ub_rows, b_ub = [], []
    for e in range(E):                # shared edge capacity
        row = np.zeros(nv)
        for c in range(n_comm):
            row[fidx(e, c)] = 1.0
            row[fidx(e + E, c)] = 1.0
        A_ub_rows.append(row)
        b_ub.append(g.capacity[e])
    # shared computation capacity: sum over streams using node n
    node_caps = {}
    for s_i, p in enumerate(problems):
        for n_i, n in enumerate(p.comp_nodes):
            node_caps.setdefault(n, (p.comp_caps[n_i], []))[1].append(
                lam_index[(s_i, n_i)])
    for n, (cap, lis) in node_caps.items():
        row = np.zeros(nv)
        for li in lis:
            row[nf + li] = 1.0
        A_ub_rows.append(row)
        b_ub.append(cap)

    bounds = [(0.0, None)] * nv
    for c, (s_i, (src, dst), li, mult) in enumerate(comm_of):
        for e_id, (a, _) in enumerate(de):
            if a == dst:
                bounds[fidx(e_id, c)] = (0.0, 0.0)

    cobj = np.zeros(nv)
    cobj[-1] = -1.0
    res = linprog(cobj, A_ub=np.array(A_ub_rows), b_ub=np.array(b_ub),
                  A_eq=np.array(A_eq_rows), b_eq=np.array(b_eq),
                  bounds=bounds, method="highs")
    if not res.success:
        return MultiStreamResult(0.0, np.zeros(NS),
                                 np.zeros((NS, 1)), res.message)
    lam = float(res.x[-1])
    per_stream = weights * lam
    per_node = np.zeros((NS, max(p.n_comp for p in problems)))
    for (s_i, n_i), li in lam_index.items():
        per_node[s_i, n_i] = res.x[nf + li]
    return MultiStreamResult(lam, per_stream, per_node, "optimal")
