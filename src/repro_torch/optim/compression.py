"""Gradient compression with error feedback for the data-parallel
all-reduce.

Port of `repro.optim.compression`: int8 quantization (one scale per
tensor, max |g| / 127, round half to even) or magnitude top-k
sparsification of ``g + residual``, the compression error carried to the
next step as the new residual.  As in the reference, compression is
applied to the gradient before the optimizer; the outputs and residuals
equal the reference's bit for bit.  These are functional: they return new
trees.  `init_ef_abstract` gives the residuals on the meta device (the
dry-run's state).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..models.common import tree_map


class EFState(NamedTuple):
    err: object          # tree like grads (float32 residuals)


def init_ef(params) -> EFState:
    return EFState(err=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def init_ef_abstract(params) -> EFState:
    return EFState(err=tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
        params))


def _q_int8(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_int8_ef(grads, ef: EFState) -> Tuple[object, EFState]:
    """Returns (decompressed grads as seen after the all-reduce, new EF
    state)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        dq = _dq_int8(*_q_int8(gf))
        return dq, gf - dq
    return _apply(one, grads, ef)


def compress_topk_ef(grads, ef: EFState, frac: float = 0.1):
    """Magnitude top-k sparsification with error feedback: each tensor
    keeps its entries with |g| at least its k-th largest |g|, k =
    max(int(n * frac), 1)."""
    def one(g, e):
        gf = g.to(torch.float32) + e
        flat = gf.reshape(-1)
        k = max(int(flat.shape[0] * frac), 1)
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = torch.where(torch.abs(gf) >= thresh, gf, 0.0)
        return kept, gf - kept
    return _apply(one, grads, ef)


def _apply(one, grads, ef: EFState):
    """``one(g, e) -> (out, residual)`` over the trees: (tree of outs,
    EFState(tree of residuals)); `tree_map` takes the pairs as leaves."""
    pairs = tree_map(one, grads, ef.err)
    return (tree_map(lambda t: t[0], pairs),
            EFState(err=tree_map(lambda t: t[1], pairs)))
