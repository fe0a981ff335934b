"""The paper's control policies as batched PyTorch slot-step functions.

Port of `repro.core.policies`.  Implemented policies (paper §III-IV):
  pi1    — single comp node, BP routing, combine all available pairs.
  pi1p   — pi1 with the proof-device computation threshold X̄ (Lemma 1).
  pi2    — pi1 + regulator/dummy randomization (overlapping networks, Thm 3).
  pi3    — multiple comp nodes: join-shortest-sum-of-queues load balancing
           (eq. 9), H_n virtual queues (eq. 10), BP routing over 3·N_C
           classes, all-possible computation, regulator randomization.
  pi3bar — pi3 without the regulator (the conjectured-optimal variant of §V).

`slot_step(pp, cfg, state, arrivals, reg_draws, eps_b)` advances every sim
of a batched `PaddedProblem` by one slot.  The decisions go through the
bp_slot wrappers only — the CUDA kernels for CUDA tensors — once for
routing and, for load-balancing policies, twice for the comp/balance
decision (before routing for n*, after routing for Z).  There is no
backend switch: the device of the tensors decides.

Scatter-adds where two edges can hit one (node, class) go through
`_scatter_add`, a deterministic sorted accumulation (never atomics), so a
sim's result does not depend on run order or on the batch it shares.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.bp_slot.kernel import (comp_balance_decide,
                                                slot_route_decide)

from .queues import NetState
from .regulator import regulator_push

#: Policies that route computation output through the dummy-packet regulator.
REGULATED_POLICIES = ("pi2", "pi2_reg", "pi3", "pi3_reg")

#: Every implemented policy name; `PolicyConfig` rejects anything else.
KNOWN_POLICIES = ("pi1", "pi1p", "pi2", "pi2_reg", "pi3", "pi3_reg",
                  "pi3bar")


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    name: str = "pi3"            # pi1 | pi1p | pi2[_reg] | pi3[_reg] | pi3bar
    eps_b: float = 0.01          # regulator Bernoulli parameter
    pairing: str = "fifo"        # fifo | bound
    threshold: float = 0.0       # X̄ for the primed (proof-device) variants
    fixed_node: int = 0          # comp-node index used by pi1/pi1p/pi2
    wireless: bool = False       # node-exclusive interference (§IV-C)

    def __post_init__(self):
        if self.name not in KNOWN_POLICIES:
            raise ValueError(
                f"unknown policy {self.name!r}; known: {KNOWN_POLICIES}")
        if self.pairing not in ("fifo", "bound"):
            raise ValueError(f"unknown pairing model {self.pairing!r}")

    @property
    def use_regulator(self) -> bool:
        return self.name in REGULATED_POLICIES

    @property
    def load_balance(self) -> bool:
        return self.name in ("pi3", "pi3_reg", "pi3bar")

    @property
    def thresholded(self) -> bool:
        return self.name == "pi1p"

    @property
    def rho0(self) -> float:
        """Output-rate inflation rho0 = 1 + eps_B for regulated policies."""
        return 1.0 + self.eps_b if self.use_regulator else 1.0


# ---------------------------------------------------------------------------
# Batched indexing helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _deterministic():
    """Scope `torch.use_deterministic_algorithms` to the scatter-adds: on
    CUDA, `index_put_(accumulate=True)` then sorts the indices (stably) and
    sums each index's updates in a fixed order instead of with atomics."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _scatter_add(base: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``base`` [B, K] plus ``vals`` [B, M] added at flat indices ``idx``
    [B, M] (colliding indices sum), out of place.  On the CPU updates apply
    in order, like the reference's `.at[].add`; on CUDA in a fixed order."""
    B, K = base.shape
    flat = (idx + torch.arange(B, device=idx.device)[:, None] * K).reshape(-1)
    out = base.clone().reshape(-1)
    with _deterministic():
        out.index_put_((flat,), vals.reshape(-1).to(out.dtype),
                       accumulate=True)
    return out.reshape(B, K)


def _qidx(NC: int, node, cls, comp):
    """Flat index of Q[b, node, cls, comp] within one sim's [N, 3, NC]."""
    return (node * 3 + cls) * NC + comp


# ---------------------------------------------------------------------------
# Backpressure routing
# ---------------------------------------------------------------------------

def greedy_maximal_matching(edges: torch.Tensor, weights: torch.Tensor,
                            n_nodes: int) -> torch.Tensor:
    """Greedy maximal matching under node-exclusive interference, per sim:
    visit links by decreasing weight (stable order), activate a link iff
    neither endpoint is busy and its weight is positive.

    edges [B, E, 2], weights [B, E] -> [B, E] bool.  A Python loop over E,
    vectorised over the fleet axis."""
    B, E = weights.shape
    order = torch.argsort(-weights, dim=1, stable=True)
    ends = edges.long()
    used = torch.zeros((B, n_nodes), dtype=torch.bool, device=weights.device)
    sel = torch.zeros((B, E), dtype=torch.bool, device=weights.device)
    for t in range(E):
        e = order[:, t:t + 1]                                     # [B, 1]
        m = torch.gather(ends[..., 0], 1, e)
        l = torch.gather(ends[..., 1], 1, e)
        ok = (~torch.gather(used, 1, m)) & (~torch.gather(used, 1, l)) & \
            (torch.gather(weights, 1, e) > 0)
        used = used.scatter(1, m, torch.gather(used, 1, m) | ok)
        used = used.scatter(1, l, torch.gather(used, 1, l) | ok)
        sel = sel.scatter(1, e, ok)
    return sel


def bp_route_slot(pp, state: NetState,
                  wireless: bool = False) -> Tuple[NetState, Dict]:
    """One slot of max-differential-backlog routing over every link of every
    sim (see `repro.core.policies.bp_route_slot`): per link, the class with
    the largest |Q_m - Q_l| gets the link rate in the decreasing direction;
    outflows are capped at queue content and split proportionally."""
    Q, Ddum, X = state.Q, state.Ddum, state.X
    B, N, _, NC = Q.shape
    m32 = pp.edges[..., 0].contiguous()
    l32 = pp.edges[..., 1].contiguous()
    m_idx, l_idx = m32.long(), l32.long()
    cap = pp.edge_cap

    best, dmax = slot_route_decide(Q.reshape(B, N, 3 * NC), m32, l32)
    best = best.long()
    best_i = best // NC
    best_n = best % NC

    nz = dmax.abs() > 0
    alloc = cap * nz
    weight = dmax.abs() * (cap > 0)
    alloc = alloc * pp.edge_mask
    weight = weight * pp.edge_mask
    if wireless:
        alloc = alloc * greedy_maximal_matching(pp.edges, weight, N)
    fwd = dmax > 0
    src = torch.where(fwd, m_idx, l_idx)
    dst = torch.where(fwd, l_idx, m_idx)

    Qv = Q.reshape(B, -1)
    k_src = _qidx(NC, src, best_i, best_n)
    total_out = _scatter_add(torch.zeros_like(Qv), k_src, alloc)
    scale = torch.where(total_out > Qv,
                        Qv / torch.clamp(total_out, min=1e-20),
                        torch.ones_like(Qv))
    actual = alloc * torch.gather(scale, 1, k_src)               # [B, E]

    Dv = Ddum.reshape(B, -1)
    q0_src = torch.gather(Qv, 1, _qidx(NC, src, 0, best_n))
    d_src = torch.gather(Dv, 1, src * NC + best_n)
    frac_dummy = torch.where(q0_src > 0,
                             d_src / torch.clamp(q0_src, min=1e-20),
                             torch.zeros_like(q0_src))
    moved_dummy = actual * frac_dummy * (best_i == 0)

    k_dst = _qidx(NC, dst, best_i, best_n)
    is_sink = torch.gather(pp.sink.reshape(B, -1), 1, k_dst)     # [B, E]
    not_sink = ~is_sink
    to_net = actual * not_sink
    # Departures then arrivals, one scatter each for Q and Ddum (the
    # reference applies them as two scatters in this order).
    Qv = _scatter_add(Qv, torch.cat([k_src, k_dst], 1),
                      torch.cat([-actual, to_net], 1))
    Dv = _scatter_add(Dv, torch.cat([src * NC + best_n, dst * NC + best_n], 1),
                      torch.cat([-moved_dummy, moved_dummy * not_sink], 1))

    raw_sink = is_sink & (best_i >= 1)
    to_X = actual * raw_sink
    kx = best_n * 2 + torch.clamp(best_i - 1, min=0)
    Xv = _scatter_add(X.reshape(B, -1), kx, to_X)
    cav = _scatter_add(state.cum_arr.reshape(B, -1), kx, to_X)

    proc_sink = is_sink & (best_i == 0)
    dlv = (actual * proc_sink).sum(1)
    dlv_useful = ((actual - moved_dummy) * proc_sink).sum(1)

    new = state.replace(Q=Qv.reshape(Q.shape), Ddum=Dv.reshape(Ddum.shape),
                        X=Xv.reshape(X.shape),
                        cum_arr=cav.reshape(X.shape))
    new = new.credit_delivery(dlv, dlv_useful)
    return new, {"routed": actual.sum(1)}


# ---------------------------------------------------------------------------
# Pairing / computation
# ---------------------------------------------------------------------------

def _x_net(state: NetState, pairing: str) -> torch.Tensor:
    """[B, NC] raw packets in flight (paper eq. (7)); zeros for fifo, which
    does not read it."""
    if pairing != "bound":
        return torch.zeros_like(state.H)
    return state.Q[:, :, 1, :].sum(1) + state.Q[:, :, 2, :].sum(1)


def _comp_balance(pp, cfg: PolicyConfig, state: NetState, eps: torch.Tensor):
    """The comp/balance decision on this state snapshot: (Z [B, NC],
    n_star [B] int32), through the `comp_balance_decide` wrapper."""
    Q = state.Q
    B, N, _, NC = Q.shape
    Qv = Q.reshape(B, -1)
    nidx = torch.arange(NC, device=Q.device)[None, :]
    q0 = torch.gather(Qv, 1, _qidx(NC, pp.comp_nodes.long(), 0, nidx))
    q1 = torch.gather(Qv, 1, _qidx(NC, pp.s1.long()[:, None], 1, nidx))
    q2 = torch.gather(Qv, 1, _qidx(NC, pp.s2.long()[:, None], 2, nidx))
    X, ca = state.X, state.cum_arr
    return comp_balance_decide(
        eps, q0, q1, q2, state.H, pp.comp_caps, pp.comp_mask,
        X[..., 0], X[..., 1], ca[..., 0], ca[..., 1], state.cum_comb,
        _x_net(state, cfg.pairing), pairing=cfg.pairing,
        thresholded=cfg.thresholded, threshold=cfg.threshold)


def _inject_processed(pp, state: NetState, amount: torch.Tensor,
                      dummy: torch.Tensor) -> NetState:
    """Push per-comp-node processed packets into Q_n^{(0,n)}, or deliver
    them where the comp node is the destination."""
    B, N, _, NC = state.Q.shape
    comp = pp.comp_nodes.long()
    at_dest = comp == pp.dest.long()[:, None]
    not_dest = ~at_dest
    nidx = torch.arange(NC, device=comp.device)[None, :]
    Qv = _scatter_add(state.Q.reshape(B, -1), _qidx(NC, comp, 0, nidx),
                      amount * not_dest)
    Dv = _scatter_add(state.Ddum.reshape(B, -1), comp * NC + nidx,
                      dummy * not_dest)
    dlv = (amount * at_dest).sum(1)
    dlv_useful = ((amount - dummy) * at_dest).sum(1)
    return state.replace(Q=Qv.reshape(state.Q.shape),
                         Ddum=Dv.reshape(state.Ddum.shape)
                         ).credit_delivery(dlv, dlv_useful)


def computation_slot(pp, cfg: PolicyConfig, state: NetState,
                     assigned: torch.Tensor, reg_draws: torch.Tensor | None,
                     eps: torch.Tensor) -> Tuple[NetState, Dict]:
    """Combine pairs at every computation node; route the output through the
    regulator (pi2/pi3 and their ``_reg`` aliases, which need
    ``reg_draws`` [B, NC]) or directly (pi1/pi3bar)."""
    Z, _ = _comp_balance(pp, cfg, state, eps)
    state = state.replace(X=state.X - Z[..., None],
                          cum_comb=state.cum_comb + Z)
    if cfg.use_regulator:
        if reg_draws is None:
            raise ValueError(f"policy {cfg.name!r} needs regulator draws")
        Y, F, dummy = regulator_push(state.Y + Z, assigned, reg_draws)
        state = _inject_processed(pp, state.replace(Y=Y), F, dummy)
    else:
        state = _inject_processed(pp, state, Z, torch.zeros_like(Z))
    return state, {"computed": Z.sum(1)}


# ---------------------------------------------------------------------------
# Load balancing (eq. 9/10) and arrival injection
# ---------------------------------------------------------------------------

def load_balance_slot(pp, cfg: PolicyConfig, state: NetState,
                      arrivals: torch.Tensor, eps: torch.Tensor
                      ) -> Tuple[NetState, torch.Tensor, Dict]:
    """Assign each sim's A(t) queries to a computation node and inject the
    raw packets at the sources.  Returns (state, assigned [B, NC], metrics)."""
    B, N, _, NC = state.Q.shape
    dev = state.Q.device
    if cfg.load_balance:
        _, n_star = _comp_balance(pp, cfg, state, eps)
        n_star = n_star.long()
    else:
        n_star = torch.full((B,), cfg.fixed_node, dtype=torch.long,
                            device=dev)
    arrivals = arrivals.to(torch.float32)
    ns = n_star[:, None]
    assigned = torch.zeros((B, NC), dtype=torch.float32, device=dev).scatter(
        1, ns, arrivals[:, None])                                  # eq. (10)

    # A source that *is* the chosen comp node feeds X directly.
    at = torch.gather(pp.comp_nodes.long(), 1, ns)[:, 0]           # [B]
    srcs = torch.stack([pp.s1.long(), pp.s2.long()], 1)            # [B, 2]
    direct = at[:, None] == srcs
    arr2 = arrivals[:, None].expand(B, 2)
    zero = torch.zeros_like(arr2)
    cls = torch.arange(1, 3, device=dev)[None, :]
    Qv = _scatter_add(state.Q.reshape(B, -1), _qidx(NC, srcs, cls, ns),
                      torch.where(direct, zero, arr2))
    kx = ns * 2 + torch.arange(2, device=dev)[None, :]
    into_x = torch.where(direct, arr2, zero)
    Xv = _scatter_add(state.X.reshape(B, -1), kx, into_x)
    cav = _scatter_add(state.cum_arr.reshape(B, -1), kx, into_x)

    H = torch.clamp(state.H + assigned - pp.comp_caps, min=0.0)   # H_n
    state = state.replace(Q=Qv.reshape(state.Q.shape),
                          X=Xv.reshape(state.X.shape),
                          cum_arr=cav.reshape(state.X.shape), H=H)
    return state, assigned, {"n_star": n_star.to(torch.int32)}


# ---------------------------------------------------------------------------
# Full slot step
# ---------------------------------------------------------------------------

def slot_step(pp, cfg: PolicyConfig, state: NetState, arrivals: torch.Tensor,
              reg_draws: torch.Tensor | None = None,
              eps_b: torch.Tensor | None = None) -> Tuple[NetState, Dict]:
    """One slot for every sim: (i) admit + load-balance, (ii) BP routing,
    (iii) computation (+ regulator push).

    arrivals [B] queries this slot; reg_draws [B, NC] the regulator's
    Bernoulli(eps_B) outcomes (regulated policies only); eps_b [B] the
    per-sim regulator parameter (default: ``cfg.eps_b`` for every sim)."""
    B = state.Q.shape[0]
    if eps_b is None:
        eps_b = torch.full((B,), cfg.eps_b, dtype=torch.float32,
                           device=state.Q.device)
    state, assigned, m1 = load_balance_slot(pp, cfg, state, arrivals, eps_b)
    state, m2 = bp_route_slot(pp, state, wireless=cfg.wireless)
    state, m3 = computation_slot(pp, cfg, state, assigned, reg_draws, eps_b)
    metrics = {
        "total_queue": state.total_queue(),
        "delivered": state.delivered,
        "delivered_useful": state.delivered_useful,
        **m1, **m2, **m3,
    }
    return state, metrics
