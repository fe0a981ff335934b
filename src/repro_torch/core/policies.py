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
of a batched `PaddedProblem` by one slot through the `slot_step_fused`
wrapper: on CUDA tensors one launch of the fused slot-step kernel
(`kernels/bp_slot/csrc/bp_slot_step.cu`) makes the whole slot of every
sim, decisions included; on CPU tensors the wrapper runs the plain version.
There is no fallback and no backend switch: the device of the tensors
decides, and a failed build or launch raises.

`slot_step_ref` (same arguments) is that plain version
(`kernels.bp_slot.ref.slot_step_plain`, the JAX package's slot step in
eager ops) with its decisions through the B1/B2 wrappers: on the card it
launches `slot_route_decide` once and `comp_balance_decide` once or twice
per slot among a few hundred eager ops.  The tests and `chip_smoke.py`
hold the fused kernel to it.

`bp_route_slot` and `computation_slot` are the reference's two phases of
a slot under its names, on the batched state: `slot_step_plain`'s routing
and computation steps, their decisions through the B1/B2 wrappers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels.bp_slot.kernel import (comp_balance_decide,
                                                slot_route_decide,
                                                slot_step_fused)
from repro_torch.kernels.bp_slot.ref import (PROBLEM_LEAVES, STATE_LEAVES,
                                             comp_balance, compute_slot,
                                             route_slot, slot_step_plain)

from .queues import NetState

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
# Full slot step
# ---------------------------------------------------------------------------

def _step(step, pp, cfg: PolicyConfig, state: NetState,
          arrivals: torch.Tensor, reg_draws, eps_b, **kw
          ) -> Tuple[NetState, Dict]:
    B = state.Q.shape[0]
    if eps_b is None:
        eps_b = torch.full((B,), cfg.eps_b, dtype=torch.float32,
                           device=state.Q.device)
    if cfg.use_regulator and reg_draws is None:
        raise ValueError(f"policy {cfg.name!r} needs regulator draws")
    if reg_draws is not None:
        reg_draws = reg_draws.to(torch.float32).contiguous()
    new, m = step({k: getattr(state, k) for k in STATE_LEAVES},
                  {k: getattr(pp, k) for k in PROBLEM_LEAVES},
                  arrivals.to(torch.float32).contiguous(), reg_draws,
                  eps_b.contiguous(), load_balance=cfg.load_balance,
                  fixed_node=cfg.fixed_node, regulated=cfg.use_regulator,
                  pairing=cfg.pairing, thresholded=cfg.thresholded,
                  threshold=cfg.threshold, wireless=cfg.wireless, **kw)
    metrics = {k: m[k] for k in ("total_queue", "delivered",
                                 "delivered_useful", "n_star", "routed",
                                 "computed")}
    return NetState(**new), metrics


def slot_step(pp, cfg: PolicyConfig, state: NetState, arrivals: torch.Tensor,
              reg_draws: torch.Tensor | None = None,
              eps_b: torch.Tensor | None = None) -> Tuple[NetState, Dict]:
    """One slot for every sim: (i) admit + load-balance, (ii) BP routing,
    (iii) computation (+ regulator push), through `slot_step_fused`.

    arrivals [B] queries this slot; reg_draws [B, NC] the regulator's
    Bernoulli(eps_B) outcomes (regulated policies only); eps_b [B] the
    per-sim regulator parameter (default: ``cfg.eps_b`` for every sim).
    Returns (state, metrics: total_queue, delivered, delivered_useful,
    n_star [B] int32, routed, computed)."""
    return _step(slot_step_fused, pp, cfg, state, arrivals, reg_draws, eps_b)


def slot_step_ref(pp, cfg: PolicyConfig, state: NetState,
                  arrivals: torch.Tensor,
                  reg_draws: torch.Tensor | None = None,
                  eps_b: torch.Tensor | None = None
                  ) -> Tuple[NetState, Dict]:
    """`slot_step`'s plain version: the same slot in eager PyTorch ops, its
    two decisions through the B1/B2 wrappers."""
    return _step(slot_step_plain, pp, cfg, state, arrivals, reg_draws, eps_b,
                 route=slot_route_decide, balance=comp_balance_decide)


# ---------------------------------------------------------------------------
# The slot's phases under the reference's names
# ---------------------------------------------------------------------------

def _leaves(pp, state: NetState):
    return ({k: getattr(pp, k) for k in PROBLEM_LEAVES},
            {k: getattr(state, k) for k in STATE_LEAVES})


def bp_route_slot(pp, state: NetState, wireless: bool = False
                  ) -> Tuple[NetState, Dict]:
    """One slot of max-differential-backlog routing over every link of
    every sim (`repro.core.policies.bp_route_slot`; greedy maximal matching
    when ``wireless``).  Returns (state, {"routed": [B]})."""
    p, s = _leaves(pp, state)
    s, routed = route_slot(p, s, wireless, route=slot_route_decide)
    return NetState(**s), {"routed": routed}


def computation_slot(pp, cfg: PolicyConfig, state: NetState,
                     assigned: torch.Tensor,
                     reg_draws: torch.Tensor | None = None,
                     eps_b: torch.Tensor | None = None
                     ) -> Tuple[NetState, Dict]:
    """Combine pairs at every computation node and push the output through
    the regulator (regulated policies, whose bits ``reg_draws`` [B, NC]
    replace the reference's key) or straight on
    (`repro.core.policies.computation_slot`).  ``assigned`` [B, NC] are the
    slot's queries per node; ``eps_b`` [B] defaults to ``cfg.eps_b``.
    Returns (state, {"computed": [B]})."""
    if cfg.use_regulator and reg_draws is None:
        raise ValueError(f"policy {cfg.name!r} needs regulator draws")
    p, s = _leaves(pp, state)
    if eps_b is None:
        eps_b = torch.full((state.Q.shape[0],), cfg.eps_b,
                           dtype=torch.float32, device=state.Q.device)
    Z, _ = comp_balance(p, s, eps_b, pairing=cfg.pairing,
                        thresholded=cfg.thresholded, threshold=cfg.threshold,
                        balance=comp_balance_decide)
    s = compute_slot(p, s, Z, assigned.to(torch.float32),
                     reg_draws.to(torch.float32) if cfg.use_regulator
                     else None)
    return NetState(**s), {"computed": Z.sum(1)}
