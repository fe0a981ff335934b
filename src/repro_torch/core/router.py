"""Backpressure MoE routing: the paper's virtual queues applied to experts.

Port of `repro.core.router` (see its docstring for the mapping).  Experts
are computation nodes with capacity C_e (tokens per step at perfect
balance); per-expert backlog counters follow the paper's H_n (eq. 10),

    H_e <- [H_e + assigned_e - C_e]^+,

and join-the-shortest-sum-of-queues (eq. 9) becomes a selection bias:

    topk_e( gate_prob_e - beta * H_e / C_e ).

Combine weights are the unbiased gate probabilities of the selected
experts, renormalised.  H is updated over micro-batches of the step's
tokens (the largest divisor of T that is <= `micro_batches`), so the bias
moves in steps of beta / micro_batches instead of bang-bang per batch.

`route` is plain PyTorch, as the reference's is plain jnp: no kernel.  Its
top-k takes the lowest index on ties, as `jax.lax.top_k` does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


class RouterState(NamedTuple):
    H: torch.Tensor          # [E] virtual admission queues (float32)
    steps: torch.Tensor      # [] int32


def init_router_state(n_experts: int, device=None) -> RouterState:
    """Zero queues on ``device``: CUDA unless asked, raising without a card
    (`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    return RouterState(H=torch.zeros((n_experts,), dtype=torch.float32,
                                     device=dev),
                       steps=torch.zeros((), dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    n_experts: int
    k: int                      # experts per token
    mode: str = "backpressure"  # backpressure | aux | plain
    beta: float = 1.0           # backpressure bias strength
    aux_coef: float = 0.01      # Switch-style aux loss coefficient (mode=aux)
    capacity_factor: float = 1.25
    micro_batches: int = 8      # H sub-updates per routing call


class RouterOut(NamedTuple):
    expert_idx: torch.Tensor    # [T, k] int64
    combine_w: torch.Tensor     # [T, k] float32, renormalised gate probs
    aux_loss: torch.Tensor      # [] aux loss (0 unless mode=aux)
    new_state: RouterState
    load: torch.Tensor          # [E] fraction of assignments per expert


def topk_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, largest first,
    the lowest index first among equal values (`jax.lax.top_k`'s order;
    `torch.topk` does not document its order on ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def expert_counts(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[E] float32 number of assignments per expert (integer-valued, exact
    in any summation order)."""
    return torch.nn.functional.one_hot(idx.reshape(-1), n_experts).sum(
        0).to(torch.float32)


def route(cfg: RouterConfig, state: RouterState,
          logits: torch.Tensor) -> RouterOut:
    """Route T tokens to k-of-E experts.  logits: [T, E]."""
    T, E = logits.shape
    if E != cfg.n_experts:
        raise ValueError(f"logits have {E} experts, config {cfg.n_experts}")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)

    capacity = torch.full((), T * cfg.k / E, dtype=torch.float32,
                          device=logits.device)
    M = max(d for d in range(1, min(cfg.micro_batches, T) + 1) if T % d == 0)
    cap_micro = capacity / M

    H = state.H
    idx, w, asg = [], [], []
    for p in probs.reshape(M, T // M, E):               # the reference's scan
        if cfg.mode == "backpressure":
            bias = cfg.beta * H / torch.clamp(capacity, min=1.0)
            sel_score = p - bias[None, :]
        else:
            sel_score = p
        i = topk_first(sel_score, cfg.k)                 # [T/M, k]
        g = torch.gather(p, 1, i)
        w.append(g / torch.clamp(g.sum(dim=1, keepdim=True), min=1e-9))
        a = expert_counts(i, E)
        H = torch.clamp(H + a - cap_micro, min=0.0)
        idx.append(i)
        asg.append(a)
    expert_idx = torch.cat(idx).reshape(T, cfg.k)
    combine_w = torch.cat(w).reshape(T, cfg.k)
    assigned = torch.stack(asg).sum(dim=0)               # [E] tokens/expert
    new_state = RouterState(H=H, steps=state.steps + 1)

    if cfg.mode == "aux":
        # Switch-Transformer load balancing loss: E * sum_e f_e * p_e.
        f = assigned / torch.clamp(assigned.sum(), min=1.0)
        aux = cfg.aux_coef * E * torch.sum(f * probs.mean(dim=0))
    else:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)

    load = assigned / torch.clamp(assigned.sum(), min=1.0)
    return RouterOut(expert_idx=expert_idx, combine_w=combine_w,
                     aux_loss=aux, new_state=new_state, load=load)


def load_violation(load: torch.Tensor) -> torch.Tensor:
    """max_e load_e / mean load — 1.0 is perfect balance."""
    return load.max() / torch.clamp(load.mean(), min=1e-9)
