"""Plain PyTorch versions of the bp_slot kernel family.

Port of `repro.kernels.bp_slot.ref`, batched: every panel gains a leading
fleet axis [B].  The expressions and their evaluation order are the JAX
package's, so on identical float32 inputs they give identical bits.  They
are what the wrappers in `kernel.py` run for CPU tensors, and what the CUDA
kernels are held to on the card: the two decisions (B1 `slot_route_ref`,
B2 `comp_balance_ref`) bit for bit, and the whole slot step
(`slot_step_plain`, the fused kernel's plain version) as `chip_smoke.py`'s
`phase_slot_step` states.

Tie-break contract: the routing argmax and the load-balance argmin resolve
ties to the lowest index, like `torch.argmax`/`torch.argmin` (first
occurrence).
"""
from __future__ import annotations

import contextlib

import torch

#: Order of the 12 per-comp-node panels in the stacked [B, 12, NC] layout
#: that `comp_balance_decide` hands its CUDA kernel.
PANELS = ("q0", "q1", "q2", "H", "caps", "mask", "x1", "x2", "ca1", "ca2",
          "cc", "x_net")


def pair_count(x1, x2, ca1, ca2, cc, x_net, pairing: str):
    """P_n(t): combinable same-tag pairs at each comp node, [B, NC]."""
    if pairing == "fifo":
        P = torch.minimum(ca1, ca2) - cc
    elif pairing == "bound":
        P = (x1 + x2 - x_net) / 2.0
    else:
        raise ValueError(f"unknown pairing model {pairing!r}")
    # jnp.clip(P, 0, hi) == minimum(maximum(P, 0), hi)
    return torch.minimum(torch.clamp(P, min=0.0), torch.minimum(x1, x2))


def combine_amount(P, caps, xsum, thresholded: bool, threshold: float):
    """Z_n(t): pairs actually combined, capped by capacity and optionally
    gated by the pi1' threshold (combine only when X1+X2 >= 2 C_n + X̄)."""
    if thresholded:
        gate = xsum >= 2.0 * caps + threshold
        return torch.minimum(torch.where(gate, caps, torch.zeros_like(caps)),
                             P)
    return torch.minimum(P, caps)


def balance_score(eps, q0, q1, q2, H, mask):
    """Join-shortest-sum-of-queues score (paper eq. (9)), +inf on masked
    comp nodes.  ``eps`` is [B]; the panels are [B, NC]."""
    score = (1.0 + eps)[:, None] * q0 + q1 + q2 + H
    if mask is None:
        return score
    return torch.where(mask > 0, score, torch.full_like(score, float("inf")))


def slot_route_ref(Qf: torch.Tensor, m_idx: torch.Tensor, l_idx: torch.Tensor):
    """BP routing decision over the flattened class axis.

    Qf: [B, N, C] per-node backlogs, classes flattened i-major
    (`Q.reshape(B, N, -1)`); m_idx/l_idx: [B, E] endpoints.  Returns
    (best [B, E] int32 flat class index, dmax [B, E] signed differential).
    Builds the whole [B, E, C] differential.
    """
    C = Qf.shape[-1]
    qm = torch.gather(Qf, 1, m_idx.long()[..., None].expand(-1, -1, C))
    ql = torch.gather(Qf, 1, l_idx.long()[..., None].expand(-1, -1, C))
    diff = qm - ql
    best = torch.argmax(diff.abs(), dim=2)
    dmax = torch.gather(diff, 2, best[..., None])[..., 0]
    return best.to(torch.int32), dmax


def comp_balance_ref(eps, q0, q1, q2, H, caps, mask, x1, x2, ca1, ca2, cc,
                     x_net, *, pairing: str, thresholded: bool,
                     threshold: float):
    """Per-comp-node decision: pairs -> combine amount Z, and the masked
    load-balance argmin n_star, from one set of panels.

    ``eps`` is [B]; every other input a [B, NC] panel.  Returns
    (Z [B, NC] f32, n_star [B] i32).
    """
    capm = caps * mask
    P = pair_count(x1, x2, ca1, ca2, cc, x_net, pairing)
    Z = combine_amount(P, capm, x1 + x2, thresholded, threshold)
    score = balance_score(eps, q0, q1, q2, H, mask)
    return Z, torch.argmin(score, dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# The slot step: plain version of the fused kernel (csrc/bp_slot_step.cu)
# ---------------------------------------------------------------------------
#
# A slot step reads and writes dicts of tensors, each with a leading fleet
# axis [B]: the queue state (STATE_LEAVES, the fields of
# `repro_torch.core.queues.NetState`) and the padded problem
# (PROBLEM_LEAVES, the fields of `repro_torch.fleet.batching.PaddedProblem`).
# Its decisions go through ``route`` and ``balance``, called as B1 and B2
# are: `slot_route_ref` and `comp_balance_ref` here, the wrappers (which
# launch the B1/B2 kernels on CUDA tensors) from
# `repro_torch.core.policies.slot_step_ref`.

#
# The two tuples below are the only lists of these leaves: `repro_torch.
# convert.STATE_FIELDS` and `repro_torch.fleet.batching.LEAVES` import
# them (core/ and fleet/ may import kernels/, never the other way round, as
# `core.policies` imports this module).  For the same reason `kahan_add`
# and `regulator_push` are defined here; `core.queues` and `core.regulator`
# re-export them under the module names they have in the JAX package,
# which the parity tests import.

#: Queue-state leaves of a slot step, in `NetState` field order.
STATE_LEAVES = ("Q", "Ddum", "X", "Y", "H", "cum_arr", "cum_comb",
                "delivered", "delivered_useful", "delivered_c",
                "delivered_useful_c")
#: Problem leaves a slot step reads, in `PaddedProblem` field order.
PROBLEM_LEAVES = ("edges", "edge_cap", "s1", "s2", "dest", "comp_nodes",
                  "comp_caps", "sink", "edge_mask", "comp_mask")


def kahan_add(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """One compensated-summation step: returns (new_sum, new_compensation)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def regulator_push(Y: torch.Tensor, assigned: torch.Tensor,
                   draws: torch.Tensor):
    """One slot of the dummy-packet regulator (paper eq. (8)) for every comp
    node: F = A (1 + B) packets leave, Y covers what it can and dummies the
    rest.  Y, assigned, draws [B, NC] (draws 0.0/1.0); returns (Y', F,
    dummy)."""
    F = assigned * (1.0 + draws.to(Y.dtype))
    useful = torch.minimum(Y, F)
    dummy = F - useful
    return Y - useful, F, dummy


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


def scatter_add(base: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``base`` [B, K] plus ``vals`` [B, M] added at flat indices ``idx``
    [B, M] (colliding indices sum), out of place.  On the CPU updates apply
    to the base in the order of the update list, like the reference's
    `.at[].add` (and the fused kernel); on CUDA each index's updates are
    summed in a fixed order, then added to the base."""
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


def _credit(s: dict, dlv: torch.Tensor, dlv_useful: torch.Tensor) -> dict:
    """Compensated update of the cumulative delivery counters."""
    d, dc = kahan_add(s["delivered"], s["delivered_c"], dlv)
    du, duc = kahan_add(s["delivered_useful"], s["delivered_useful_c"],
                        dlv_useful)
    return {**s, "delivered": d, "delivered_c": dc, "delivered_useful": du,
            "delivered_useful_c": duc}


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


def route_slot(p: dict, s: dict, wireless: bool, route=slot_route_ref):
    """One slot of max-differential-backlog routing over every link of every
    sim (`repro.core.policies.bp_route_slot`): per link, the class with the
    largest |Q_m - Q_l| gets the link rate in the decreasing direction;
    outflows are capped at queue content and split proportionally.
    Returns (state, routed [B])."""
    Q, Ddum, X = s["Q"], s["Ddum"], s["X"]
    B, N, _, NC = Q.shape
    m32 = p["edges"][..., 0].contiguous()
    l32 = p["edges"][..., 1].contiguous()
    m_idx, l_idx = m32.long(), l32.long()
    cap = p["edge_cap"]

    best, dmax = route(Q.reshape(B, N, 3 * NC), m32, l32)
    best = best.long()
    best_i = best // NC
    best_n = best % NC

    nz = dmax.abs() > 0
    alloc = cap * nz
    weight = dmax.abs() * (cap > 0)
    alloc = alloc * p["edge_mask"]
    weight = weight * p["edge_mask"]
    if wireless:
        alloc = alloc * greedy_maximal_matching(p["edges"], weight, N)
    fwd = dmax > 0
    src = torch.where(fwd, m_idx, l_idx)
    dst = torch.where(fwd, l_idx, m_idx)

    Qv = Q.reshape(B, -1)
    k_src = _qidx(NC, src, best_i, best_n)
    total_out = scatter_add(torch.zeros_like(Qv), k_src, alloc)
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
    is_sink = torch.gather(p["sink"].reshape(B, -1), 1, k_dst)   # [B, E]
    not_sink = ~is_sink
    to_net = actual * not_sink
    # Departures then arrivals, one scatter each for Q and Ddum (the
    # reference applies them as two scatters in this order).
    Qv = scatter_add(Qv, torch.cat([k_src, k_dst], 1),
                     torch.cat([-actual, to_net], 1))
    Dv = scatter_add(Dv, torch.cat([src * NC + best_n, dst * NC + best_n], 1),
                     torch.cat([-moved_dummy, moved_dummy * not_sink], 1))

    raw_sink = is_sink & (best_i >= 1)
    to_X = actual * raw_sink
    kx = best_n * 2 + torch.clamp(best_i - 1, min=0)
    Xv = scatter_add(X.reshape(B, -1), kx, to_X)
    cav = scatter_add(s["cum_arr"].reshape(B, -1), kx, to_X)

    proc_sink = is_sink & (best_i == 0)
    dlv = (actual * proc_sink).sum(1)
    dlv_useful = ((actual - moved_dummy) * proc_sink).sum(1)

    s = {**s, "Q": Qv.reshape(Q.shape), "Ddum": Dv.reshape(Ddum.shape),
         "X": Xv.reshape(X.shape), "cum_arr": cav.reshape(X.shape)}
    return _credit(s, dlv, dlv_useful), actual.sum(1)


def _x_net(Q: torch.Tensor, pairing: str) -> torch.Tensor:
    """[B, NC] raw packets in flight (paper eq. (7)); zeros for fifo, which
    does not read it."""
    if pairing != "bound":
        return torch.zeros_like(Q[:, 0, 0, :])
    return Q[:, :, 1, :].sum(1) + Q[:, :, 2, :].sum(1)


def comp_balance(p: dict, s: dict, eps: torch.Tensor, *, pairing: str,
                 thresholded: bool, threshold: float,
                 balance=comp_balance_ref):
    """The comp/balance decision on this state snapshot through
    ``balance``: (Z [B, NC], n_star [B] int32)."""
    Q = s["Q"]
    B, N, _, NC = Q.shape
    Qv = Q.reshape(B, -1)
    nidx = torch.arange(NC, device=Q.device)[None, :]
    q0 = torch.gather(Qv, 1, _qidx(NC, p["comp_nodes"].long(), 0, nidx))
    q1 = torch.gather(Qv, 1, _qidx(NC, p["s1"].long()[:, None], 1, nidx))
    q2 = torch.gather(Qv, 1, _qidx(NC, p["s2"].long()[:, None], 2, nidx))
    X, ca = s["X"], s["cum_arr"]
    return balance(eps, q0, q1, q2, s["H"], p["comp_caps"], p["comp_mask"],
                   X[..., 0], X[..., 1], ca[..., 0], ca[..., 1],
                   s["cum_comb"], _x_net(Q, pairing), pairing=pairing,
                   thresholded=thresholded, threshold=threshold)


def admit(p: dict, s: dict, arrivals: torch.Tensor, n_star: torch.Tensor):
    """Assign each sim's A(t) queries to comp node ``n_star`` [B] and inject
    the raw packets at the sources.  Returns (state, assigned [B, NC])."""
    B, N, _, NC = s["Q"].shape
    dev = s["Q"].device
    arrivals = arrivals.to(torch.float32)
    ns = n_star.long()[:, None]
    assigned = torch.zeros((B, NC), dtype=torch.float32, device=dev).scatter(
        1, ns, arrivals[:, None])                                  # eq. (10)

    # A source that *is* the chosen comp node feeds X directly.
    at = torch.gather(p["comp_nodes"].long(), 1, ns)[:, 0]         # [B]
    srcs = torch.stack([p["s1"].long(), p["s2"].long()], 1)        # [B, 2]
    direct = at[:, None] == srcs
    arr2 = arrivals[:, None].expand(B, 2)
    zero = torch.zeros_like(arr2)
    cls = torch.arange(1, 3, device=dev)[None, :]
    Qv = scatter_add(s["Q"].reshape(B, -1), _qidx(NC, srcs, cls, ns),
                     torch.where(direct, zero, arr2))
    kx = ns * 2 + torch.arange(2, device=dev)[None, :]
    into_x = torch.where(direct, arr2, zero)
    Xv = scatter_add(s["X"].reshape(B, -1), kx, into_x)
    cav = scatter_add(s["cum_arr"].reshape(B, -1), kx, into_x)

    H = torch.clamp(s["H"] + assigned - p["comp_caps"], min=0.0)   # H_n
    s = {**s, "Q": Qv.reshape(s["Q"].shape), "X": Xv.reshape(s["X"].shape),
         "cum_arr": cav.reshape(s["X"].shape), "H": H}
    return s, assigned


def compute_slot(p: dict, s: dict, Z: torch.Tensor, assigned: torch.Tensor,
                 reg_draws: torch.Tensor | None) -> dict:
    """Combine ``Z`` [B, NC] pairs at every computation node; push the
    output through the regulator when ``reg_draws`` [B, NC] are given, else
    straight into Q_n^{(0,n)}, or deliver it where the comp node is the
    destination."""
    B, N, _, NC = s["Q"].shape
    s = {**s, "X": s["X"] - Z[..., None], "cum_comb": s["cum_comb"] + Z}
    if reg_draws is not None:
        Y, amount, dummy = regulator_push(s["Y"] + Z, assigned, reg_draws)
        s = {**s, "Y": Y}
    else:
        amount, dummy = Z, torch.zeros_like(Z)
    comp = p["comp_nodes"].long()
    at_dest = comp == p["dest"].long()[:, None]
    not_dest = ~at_dest
    nidx = torch.arange(NC, device=comp.device)[None, :]
    Qv = scatter_add(s["Q"].reshape(B, -1), _qidx(NC, comp, 0, nidx),
                     amount * not_dest)
    Dv = scatter_add(s["Ddum"].reshape(B, -1), comp * NC + nidx,
                     dummy * not_dest)
    dlv = (amount * at_dest).sum(1)
    dlv_useful = ((amount - dummy) * at_dest).sum(1)
    s = {**s, "Q": Qv.reshape(s["Q"].shape),
         "Ddum": Dv.reshape(s["Ddum"].shape)}
    return _credit(s, dlv, dlv_useful)


def slot_step_plain(state: dict, problem: dict, arrivals: torch.Tensor,
                    reg_draws: torch.Tensor | None, eps_b: torch.Tensor, *,
                    load_balance: bool, fixed_node: int, regulated: bool,
                    pairing: str, thresholded: bool, threshold: float,
                    wireless: bool, route=slot_route_ref,
                    balance=comp_balance_ref):
    """One slot for every sim, in the JAX package's order
    (`repro.core.policies.slot_step`): (i) the load-balance decision n*
    (eq. 9; ``fixed_node`` unless ``load_balance``), admission and H
    (eq. 10); (ii) BP routing (greedy matching if ``wireless``); (iii) the
    combine decision Z on the routed state, computation and the regulator
    push (``regulated``) or direct injection.

    ``state``/``problem``: dicts of STATE_LEAVES / PROBLEM_LEAVES tensors;
    arrivals [B] queries this slot; reg_draws [B, NC] the regulator's
    Bernoulli(eps_B) outcomes (read only when ``regulated``); eps_b [B].
    Returns (new state dict, metrics: total_queue, delivered,
    delivered_useful, n_star [B] int32, routed, computed, and Z [B, NC]
    the pairs combined)."""
    if regulated and reg_draws is None:
        raise ValueError("a regulated policy needs regulator draws")
    decide = dict(pairing=pairing, thresholded=thresholded,
                  threshold=threshold, balance=balance)
    B = state["Q"].shape[0]
    if load_balance:
        _, n_star = comp_balance(problem, state, eps_b, **decide)
    else:
        n_star = torch.full((B,), fixed_node, dtype=torch.int32,
                            device=state["Q"].device)
    s, assigned = admit(problem, state, arrivals, n_star)
    s, routed = route_slot(problem, s, wireless, route=route)
    Z, _ = comp_balance(problem, s, eps_b, **decide)
    s = compute_slot(problem, s, Z, assigned,
                     reg_draws if regulated else None)
    total_queue = (s["Q"].reshape(B, -1).sum(1) + s["X"].reshape(B, -1).sum(1)
                   + s["Y"].sum(1))
    return s, {"total_queue": total_queue, "delivered": s["delivered"],
               "delivered_useful": s["delivered_useful"], "n_star": n_star,
               "routed": routed, "computed": Z.sum(1), "Z": Z}
