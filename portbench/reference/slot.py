"""One slot of policy pi3 / pi3_reg / pi3bar in plain NumPy (paper
Sec. III-IV), batched over lanes [B]: join-shortest-sum-of-queues load
balancing with the virtual queues H_n (eqs. 9-10), max-differential-backlog
routing over the 3 N_C classes, same-tag (fifo) combining at each
computation node, and the dummy-packet regulator (eq. 8).

A frozen copy of the semantics the system under test implements, written
for clarity: float32 arithmetic, scatters applied in the order of their
update list (`np.add.at`).

State (per lane b): Q[b, k, i, n] the data queue at node k of class (i, n),
i = 0 processed, 1 raw from s1, 2 raw from s2; Ddum[b, k, n] the dummy
content of Q[b, k, 0, n]; X[b, n, i] raw packets at comp node n;
Y[b, n] the regulator queue; H[b, n] the virtual admission queue;
cum_arr[b, n, i] and cum_comb[b, n] the fifo pairing counters; delivered
and delivered_useful with their Kahan compensations.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def zero_state(B: int, N: int, NC: int) -> dict:
    def z(*shape):
        return np.zeros(shape, F32)
    return {"Q": z(B, N, 3, NC), "Ddum": z(B, N, NC), "X": z(B, NC, 2),
            "Y": z(B, NC), "H": z(B, NC), "cum_arr": z(B, NC, 2),
            "cum_comb": z(B, NC), "delivered": z(B),
            "delivered_useful": z(B), "delivered_c": z(B),
            "delivered_useful_c": z(B)}


def kahan_add(s, c, x):
    y = x - c
    t = s + y
    return t, (t - s) - y


def scatter_add(base, idx, vals):
    """``base`` [B, K] plus ``vals`` [B, M] at flat indices ``idx`` [B, M],
    each update applied in list order; out of place."""
    B, K = base.shape
    out = base.reshape(-1).copy()
    np.add.at(out, (idx + np.arange(B)[:, None] * K).reshape(-1),
              vals.reshape(-1).astype(F32))
    return out.reshape(B, K)


def _take(a, idx):
    """a[b, idx[b, ...]] for every lane b (the rest of a's axes kept)."""
    rows = np.arange(a.shape[0]).reshape(-1, *([1] * (idx.ndim - 1)))
    return a[rows, idx]


def _qidx(NC, node, cls, comp):
    return (node * 3 + cls) * NC + comp


def _credit(s, dlv, dlv_useful):
    d, dc = kahan_add(s["delivered"], s["delivered_c"], dlv)
    du, duc = kahan_add(s["delivered_useful"], s["delivered_useful_c"],
                        dlv_useful)
    return {**s, "delivered": d, "delivered_c": dc, "delivered_useful": du,
            "delivered_useful_c": duc}


def balance(p, s, eps):
    """n* (eq. 9): the unmasked comp node of least (1+eps) q0 + q1 + q2 + H,
    lowest index on ties."""
    B, N, _, NC = s["Q"].shape
    Qv = s["Q"].reshape(B, -1)
    n = np.arange(NC)[None, :]
    q0 = _take(Qv, _qidx(NC, p["comp_nodes"], 0, n))
    q1 = _take(Qv, _qidx(NC, p["s1"][:, None], 1, n))
    q2 = _take(Qv, _qidx(NC, p["s2"][:, None], 2, n))
    score = (F32(1.0) + eps)[:, None] * q0 + q1 + q2 + s["H"]
    score = np.where(p["comp_mask"] > 0, score, F32(np.inf))
    return np.argmin(score, axis=1)


def combine_amount(p, s):
    """Z_n: fifo same-tag pairs, capped by the (masked) capacity."""
    X, ca = s["X"], s["cum_arr"]
    P = np.minimum(ca[..., 0], ca[..., 1]) - s["cum_comb"]
    P = np.minimum(np.maximum(P, F32(0.0)), np.minimum(X[..., 0], X[..., 1]))
    return np.minimum(P, p["comp_caps"] * p["comp_mask"])


def admit(p, s, arrivals, n_star):
    B, N, _, NC = s["Q"].shape
    ns = n_star[:, None]
    assigned = np.zeros((B, NC), F32)
    np.put_along_axis(assigned, ns, arrivals[:, None], 1)
    at = _take(p["comp_nodes"], ns)[:, 0]
    srcs = np.stack([p["s1"], p["s2"]], 1)
    direct = at[:, None] == srcs
    arr2 = np.broadcast_to(arrivals[:, None], (B, 2))
    zero = np.zeros((B, 2), F32)
    cls = np.arange(1, 3)[None, :]
    Qv = scatter_add(s["Q"].reshape(B, -1), _qidx(NC, srcs, cls, ns),
                     np.where(direct, zero, arr2))
    kx = ns * 2 + np.arange(2)[None, :]
    into_x = np.where(direct, arr2, zero)
    Xv = scatter_add(s["X"].reshape(B, -1), kx, into_x)
    cav = scatter_add(s["cum_arr"].reshape(B, -1), kx, into_x)
    H = np.maximum(s["H"] + assigned - p["comp_caps"], F32(0.0))
    return {**s, "Q": Qv.reshape(s["Q"].shape),
            "X": Xv.reshape(s["X"].shape),
            "cum_arr": cav.reshape(s["X"].shape), "H": H}, assigned


def greedy_matching(edges, weight, N):
    """Node-exclusive interference (paper Sec. IV-C): visit links by
    decreasing weight, the lower link index first on ties, and activate a
    link iff its weight is positive and neither end is already active.
    edges [B, E, 2], weight [B, E] -> [B, E] bool."""
    B, E = weight.shape
    rows = np.arange(B)
    order = np.argsort(-weight, axis=1, kind="stable")
    used = np.zeros((B, N), bool)
    sel = np.zeros((B, E), bool)
    for j in range(E):
        e = order[:, j]
        m, l = edges[rows, e, 0], edges[rows, e, 1]
        ok = ~used[rows, m] & ~used[rows, l] & (weight[rows, e] > 0)
        used[rows, m] |= ok
        used[rows, l] |= ok
        sel[rows, e] = ok
    return sel


def route(p, s):
    """Per link, the class of largest |Q_m - Q_l| (lowest index on ties)
    moves at the link rate toward the smaller queue; outflows are capped at
    queue content and split proportionally.  On a wireless lane only the
    links of a greedy matching by |Q_m - Q_l| move."""
    Q, Ddum, X = s["Q"], s["Ddum"], s["X"]
    B, N, _, NC = Q.shape
    m, l = p["edges"][..., 0], p["edges"][..., 1]
    Qf = Q.reshape(B, N, 3 * NC)
    diff = _take(Qf, m) - _take(Qf, l)                            # [B, E, C]
    best = np.argmax(np.abs(diff), axis=2)
    dmax = np.take_along_axis(diff, best[..., None], 2)[..., 0]
    best_i, best_n = best // NC, best % NC
    alloc = p["edge_cap"] * (np.abs(dmax) > 0) * p["edge_mask"]
    wl = np.flatnonzero(p["wireless"])
    if wl.size:
        weight = np.abs(dmax[wl]) * (p["edge_cap"][wl] > 0) \
            * p["edge_mask"][wl]
        alloc[wl] = alloc[wl] * greedy_matching(p["edges"][wl], weight, N)
    fwd = dmax > 0
    src = np.where(fwd, m, l)
    dst = np.where(fwd, l, m)

    Qv = Q.reshape(B, -1)
    k_src = _qidx(NC, src, best_i, best_n)
    total_out = scatter_add(np.zeros_like(Qv), k_src, alloc)
    scale = np.where(total_out > Qv,
                     Qv / np.maximum(total_out, F32(1e-20)), F32(1.0))
    actual = alloc * _take(scale, k_src)

    Dv = Ddum.reshape(B, -1)
    q0_src = _take(Qv, _qidx(NC, src, 0, best_n))
    d_src = _take(Dv, src * NC + best_n)
    frac_dummy = np.where(q0_src > 0,
                          d_src / np.maximum(q0_src, F32(1e-20)), F32(0.0))
    moved_dummy = actual * frac_dummy * (best_i == 0)

    k_dst = _qidx(NC, dst, best_i, best_n)
    is_sink = _take(p["sink"].reshape(B, -1), k_dst)
    not_sink = ~is_sink
    Qv = scatter_add(Qv, np.concatenate([k_src, k_dst], 1),
                     np.concatenate([-actual, actual * not_sink], 1))
    Dv = scatter_add(Dv, np.concatenate([src * NC + best_n,
                                         dst * NC + best_n], 1),
                     np.concatenate([-moved_dummy, moved_dummy * not_sink], 1))
    to_X = actual * (is_sink & (best_i >= 1))
    kx = best_n * 2 + np.maximum(best_i - 1, 0)
    Xv = scatter_add(X.reshape(B, -1), kx, to_X)
    cav = scatter_add(s["cum_arr"].reshape(B, -1), kx, to_X)
    proc = is_sink & (best_i == 0)
    dlv = (actual * proc).sum(1, dtype=F32)
    dlv_useful = ((actual - moved_dummy) * proc).sum(1, dtype=F32)
    s = {**s, "Q": Qv.reshape(Q.shape), "Ddum": Dv.reshape(Ddum.shape),
         "X": Xv.reshape(X.shape), "cum_arr": cav.reshape(X.shape)}
    return _credit(s, dlv, dlv_useful)


def compute(p, s, Z, assigned, reg_bits):
    """Combine Z pairs; push the output through the regulator (F = A(1+B)
    leave, Y covers what it can, dummies the rest) or straight on."""
    B, N, _, NC = s["Q"].shape
    s = {**s, "X": s["X"] - Z[..., None], "cum_comb": s["cum_comb"] + Z}
    if reg_bits is not None:
        Yz = s["Y"] + Z
        amount = assigned * (F32(1.0) + reg_bits)
        useful = np.minimum(Yz, amount)
        dummy = amount - useful
        s = {**s, "Y": Yz - useful}
    else:
        amount, dummy = Z, np.zeros_like(Z)
    comp = p["comp_nodes"]
    off_dest = comp != p["dest"][:, None]
    n = np.arange(NC)[None, :]
    Qv = scatter_add(s["Q"].reshape(B, -1), _qidx(NC, comp, 0, n),
                     amount * off_dest)
    Dv = scatter_add(s["Ddum"].reshape(B, -1), comp * NC + n,
                     dummy * off_dest)
    dlv = (amount * ~off_dest).sum(1, dtype=F32)
    dlv_useful = ((amount - dummy) * ~off_dest).sum(1, dtype=F32)
    s = {**s, "Q": Qv.reshape(s["Q"].shape),
         "Ddum": Dv.reshape(s["Ddum"].shape)}
    return _credit(s, dlv, dlv_useful)


def slot(p: dict, s: dict, arrivals, reg_bits, eps):
    """One slot of every lane: (new state, metrics).  ``p`` holds the
    problem (edges [B, E, 2], comp_nodes [B, NC], s1, s2, dest [B] as
    integers; edge_cap, edge_mask, comp_caps, comp_mask float32; sink
    [B, N, 3, NC] and wireless [B] bool); arrivals [B] float32;
    ``reg_bits`` [B, NC] float32 0/1, or None for an unregulated policy;
    eps [B] float32."""
    B = s["Q"].shape[0]
    n_star = balance(p, s, eps)
    s, assigned = admit(p, s, arrivals, n_star)
    s = route(p, s)
    Z = combine_amount(p, s)
    s = compute(p, s, Z, assigned, reg_bits)
    total = (s["Q"].reshape(B, -1).sum(1, dtype=F32)
             + s["X"].reshape(B, -1).sum(1, dtype=F32)
             + s["Y"].sum(1, dtype=F32))
    return s, {"total_queue": total, "delivered": s["delivered"],
               "delivered_useful": s["delivered_useful"],
               "computed": Z.sum(1, dtype=F32), "n_star": n_star}
