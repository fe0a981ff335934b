"""Mixture-of-Experts FFN with backpressure (paper eq. 9/10) routing.

Port of `repro.models.moe` for one card.  Dispatch is sort-based with a
static expert capacity: assignments are ranked within their expert by a
stable argsort over expert ids and placed into [E, cap, d] buffers
(overflow goes to a sink row and is dropped, like the paper's finite
computation capacity C_n).  The reference's expert-parallel resharding
hooks (`ep_in`/`ep_out`) are identity on one card and are not ported.

Routing (`_route`) has the reference's two branches: ``use_kernel=True``
runs the whole gate after the router projection through `bp_topk_route`
(on a CUDA tensor one launch of a hand-written kernel: the H-bias, the
reference's fused bp_topk gate, the expert counts and the H update), used
for inference routing and training (when the logits need a gradient, through
`kernels.bp_topk.ops.BpTopkRouteFn`, which carries the gradient of the
weights); ``use_kernel=False`` runs the plain softmax/top-k path.  Both
take the lowest expert index on ties.  As in the reference, no gradient
flows through the bias H / C, the counts, H or the aux loss's load
fractions.

The combine is deterministic: each token's k contributions are gathered
in the token's own pick order and summed over k, with no scatter-add; it
differs from the reference's scatter-add (which adds in expert-sorted
order) by rounding only.

Two additions of the port's own, for DeepSeek-V3's block (configs with
``score_func`` and ``n_shared_experts``, `configs.moonlight_16b_a3b`): a
sigmoid gate, which selects by sigmoid(logit) - H / C_e and weights the
picks by their sigmoids over their sum times ``routed_scale`` (both
branches; no gradient: training such a model is not ported), and shared
experts, one SwiGLU beside the routed ones that every token passes,
unweighted (`_shared_expert`, span ``moe.shared``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from ..core.router import RouterState, expert_counts, topk_first
from ..kernels.bp_topk.kernel import bp_topk_route
from ..kernels.bp_topk.ops import bp_topk_route_fn
from ..obs import spans
from .common import Init, init_mlp, swiglu


def init_moe(cfg, ini: Init) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": ini.param((d, E), ("embed", "experts"), scale=0.02),
        "gate": ini.param((E, d, ff), ("experts", "embed", "expert_ff")),
        "up": ini.param((E, d, ff), ("experts", "embed", "expert_ff")),
        "down": ini.param((E, ff, d), ("experts", "expert_ff", "embed")),
    }
    shared = getattr(cfg, "n_shared_experts", 0)
    if shared:
        p["shared"] = init_mlp(cfg, ini, ff=shared * ff)
    return p


def _shared_expert(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' output for every token of x [B, S, d]."""
    return swiglu(x, p["gate"], p["up"], p["down"])


def _route(cfg, p, x_flat, router_state: RouterState, *,
           use_kernel: bool = False):
    """Select k experts per token.  x_flat: [G, Tg, d].

    Returns (idx [G, Tg, k] int64, w [G, Tg, k], new_state, aux, counts)."""
    G, Tg, _ = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", x_flat,
                          p["router"].to(x_flat.dtype))
    sigmoid = getattr(cfg, "score_func", "softmax") == "sigmoid"
    if sigmoid and logits.requires_grad:
        raise NotImplementedError(
            f"{cfg.name}: the sigmoid gate has no gradient (training a "
            f"model with it is not ported)")
    if use_kernel:
        # one launch: bias, gate, counts, H update (logits read in place);
        # through the Function that carries dL/dw when one is needed
        if sigmoid:
            gate = functools.partial(bp_topk_route, score="sigmoid",
                                     scale=cfg.routed_scale)
        else:
            gate = bp_topk_route_fn if logits.requires_grad else bp_topk_route
        idx, w, counts, H_new, steps = gate(
            logits.reshape(G * Tg, E).contiguous(),
            router_state.H.contiguous(), router_state.steps,
            G * Tg * k / E, k, backpressure=cfg.router == "backpressure")
        idx, w = idx.reshape(G, Tg, k), w.reshape(G, Tg, k)
        new_state = RouterState(H=H_new, steps=steps)
        probs = (torch.softmax(logits.to(torch.float32), dim=-1)
                 if cfg.router == "aux" else None)
    else:
        probs = (torch.sigmoid(logits.to(torch.float32)) if sigmoid else
                 torch.softmax(logits.to(torch.float32), dim=-1))
        cap_step = torch.full((), G * Tg * k / E, dtype=torch.float32,
                              device=x_flat.device)        # C_e per step
        if cfg.router == "backpressure":
            bias = router_state.H / torch.clamp(cap_step, min=1.0)
        else:
            bias = torch.zeros((E,), dtype=torch.float32,
                               device=x_flat.device)
        idx = topk_first(probs - bias[None, None, :], k)      # [G, Tg, k]
        w = torch.gather(probs, -1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        if sigmoid:
            w = w * cfg.routed_scale
        counts = expert_counts(idx, E)
        H_new = torch.clamp(router_state.H + counts - cap_step, min=0.0)
        new_state = RouterState(H=H_new, steps=router_state.steps + 1)

    if cfg.router == "aux":
        f = counts / torch.clamp(counts.sum(), min=1.0)
        pbar = probs.mean(dim=(0, 1))
        aux = 0.01 * E * torch.sum(f * pbar)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=x_flat.device)
    return idx, w.to(x_flat.dtype), new_state, aux, counts


def moe_ffn(cfg, p: dict, x: torch.Tensor, router_state: RouterState, *,
            group_size: int | None = None, dropless: bool = False,
            use_kernel: bool = False
            ) -> Tuple[torch.Tensor, RouterState, torch.Tensor]:
    """x: [B, S, d] -> (y, new_router_state, aux_loss).

    Groups default to one per sequence (G=B, Tg=S).  dropless=True sizes
    the expert buffers to the worst case (decode: capacity = all tokens of
    the group).  ``use_kernel`` selects `_route`'s branch.  A layer with
    shared experts (``p["shared"]``) adds their output to the routed
    one."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    if group_size is None:
        G, Tg = B, S
    else:
        Tg = min(group_size, T)
        G = T // Tg
    if G * Tg != T:
        raise ValueError(f"group size {Tg} does not divide {T} tokens")
    xf = x.reshape(G, Tg, d)
    dev = x.device

    idx, w, new_state, aux, _ = _route(cfg, p, xf, router_state,
                                       use_kernel=use_kernel)

    if dropless:
        cap = Tg
    else:
        cap = max(int(math.ceil(Tg * k / E * cfg.capacity_factor)), 1)
    tk = Tg * k
    e_flat = idx.reshape(G, tk)                 # assignment (t, j) at t*k + j

    order = torch.argsort(e_flat, dim=-1, stable=True)        # [G, tk]
    e_sorted = torch.gather(e_flat, 1, order)
    # rank within expert: position in the sorted run minus the run's start
    starts = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(G, E).contiguous(),
        right=False)
    pos = torch.arange(tk, device=dev)[None, :] - torch.gather(
        starts, 1, e_sorted)
    slot_sorted = torch.where(pos < cap, e_sorted * cap + pos,
                              E * cap)                         # overflow sink
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)

    # dispatch: every assignment's token row into its slot.  Slots below
    # E*cap are distinct; overflowed assignments all write the sink row
    # E*cap, which is dropped, so which of them lands there does not matter.
    rows = torch.arange(G, device=dev)[:, None]
    buf = torch.zeros((G, E * cap + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = xf[:, :, None, :].expand(G, Tg, k, d).reshape(G, tk, d)
    X = buf[:, : E * cap].reshape(G, E, cap, d)

    dt = x.dtype
    g = torch.einsum("gecd,edf->gecf", X, p["gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", X, p["up"].to(dt))
    Y = torch.einsum("gecf,efd->gecd", torch.nn.functional.silu(g) * u,
                     p["down"].to(dt))

    # combine: each assignment's expert output (0 from the sink), weighted,
    # summed over the token's k picks in pick order
    Yflat = torch.cat([Y.reshape(G, E * cap, d),
                       torch.zeros((G, 1, d), dtype=dt, device=dev)], dim=1)
    vals = Yflat[rows, slot] * w.reshape(G, tk)[..., None]     # [G, tk, d]
    out = vals.reshape(G, Tg, k, d).sum(dim=2).reshape(B, S, d)
    if "shared" in p:
        with spans.span("moe.shared", device=dev):
            out = out + _shared_expert(p["shared"], x)
    return out, new_state, aux
