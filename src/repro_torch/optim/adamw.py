"""AdamW with global-norm clipping and a warmup+cosine schedule.

Port of `repro.optim.adamw` over the port's parameter trees (nested dicts
of tensors), with the reference's arithmetic per element, not
`torch.optim.AdamW`'s (whose schedule and rounding differ): gradients in
float32, clipped by the global norm, bias-corrected moments in float32,
and the decoupled weight decay as the reference writes it,
``step = m^ / (sqrt(v^) + eps) + wd * p`` and then ``p - lr * step``.

`AdamW.update` writes the new moments and parameters into the tensors it
is given (the reference donates them to its jitted step) and returns
them, one leaf at a time, so that a 1.6 GB leaf needs a few temporaries
of its own size and no copy of the whole tree.  `init_abstract` gives the
same state on the meta device (shapes and dtypes, no storage) for the
dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..models.common import tree_leaves, tree_map

class AdamWState(NamedTuple):
    count: torch.Tensor   # [] int32
    m: object             # tree like params (float32)
    v: object             # tree like params (float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments in float32 and a zero count, on the params'
        device."""
        leaves = tree_leaves(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32,
                              device=leaves[0].device),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    def init_abstract(self, params) -> AdamWState:
        """`init`'s state on the meta device: float32 moments of each
        param's shape and an int32 count, nothing allocated."""
        meta = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                     device="meta")
        return AdamWState(
            count=torch.empty((), dtype=torch.int32, device="meta"),
            m=tree_map(meta, params), v=tree_map(meta, params))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32,
                            device=count.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: returns (params, AdamWState(count + 1, m, v)), the
        params and moments updated in place (module docstring)."""
        gs = [g.to(torch.float32) for g in tree_leaves(grads)]
        scale = None
        if self.clip_norm:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c = count.to(torch.float32)
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        lr = self._lr(count)
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.m),
                              tree_leaves(state.v), gs):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            del g
            step = m / bc1                           # m^
            den = v / bc2                            # v^
            step.div_(den.sqrt_().add_(self.eps))
            del den
            p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
            if self.weight_decay:
                step.add_(p32 * self.weight_decay)
            step.mul_(lr)
            if p32 is p:
                p.sub_(step)
            else:
                p.copy_((p32 - step).to(p.dtype))
        return params, AdamWState(count=count, m=state.m, v=state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of each leaf's sum
    of squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor * peak`` at ``total``: ``sched(count) -> lr`` (0-d float32
    on the count's device)."""
    def sched(count):
        c = count.to(torch.float32)
        warm = peak * c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup, warm, cos)
    return sched
