"""Plain PyTorch versions of the backpressure top-k gate (bp_topk) and of
the whole gate of one MoE layer (bp_topk_route).

Port of what `repro.kernels.bp_topk.kernel._bp_topk_kernel` computes for
every row of [T, E] scores:

  1. the row max m;
  2. probs = exp(s - m) / sum(exp(s - m));
  3. sel = probs - bias;
  4. k passes of argmax over sel, lowest index on ties, each pass masking
     its pick with NEG (the reference kernel's -1e30);
  5. w = the picked probs over max(their sum, 1e-9), the sum taken in pick
     order j = 0..k-1.

It spells the CUDA kernel's order of additions (`csrc/bp_topk.cu`), so on
the card the kernel is held to it bit for bit: the row sum of exp is the
kernel's warp reduction, one partial per lane (lane l adds the entries
l, l+32, l+64, ... in that order) and then halving adds over the 32 lanes
(the butterfly of `__shfl_xor_sync`), with E padded by zeros to a
multiple of 32.  The max and the argmax are exact in any order.  Against
the JAX package it agrees to rounding, not bit for bit: XLA sums the
softmax in another order.

`bp_topk_route_ref` is the function of `csrc/bp_topk_route.cu`: the bias
H / max(cap, 1), `bp_topk_ref` on the logits widened to float32, the
expert counts and the H update of `repro.models.moe._route`.  Its top k
is `bp_topk_ref`'s, which the fused kernel's sort gives as well (the k
largest sel in order, the lowest index on ties), so the kernel is held to
it bit for bit.  Its sigmoid mode (`bp_topk_sigmoid_ref`, the port's own)
scores each logit by 1 / (1 + exp(-s)), each step rounded once as the
kernel rounds it, and scales the weights by the routed factor after the
division.
"""
from __future__ import annotations

import torch

NEG = -1e30        # the reference kernel's mask value for picked experts
WARP = 32


def warp_sum(x: torch.Tensor) -> torch.Tensor:
    """[T, E] -> [T]: the kernel's warp reduction order (module docstring)."""
    T, E = x.shape
    R = -(-E // WARP)
    x = torch.nn.functional.pad(x, (0, R * WARP - E)).reshape(T, R, WARP)
    acc = torch.zeros((T, WARP), dtype=x.dtype, device=x.device)
    for r in range(R):                       # each lane's strided partial
        acc = acc + x[:, r]
    width = WARP
    while width > 1:                         # butterfly: offsets 16 .. 1
        width //= 2
        acc = acc[:, :width] + acc[:, width:]
    return acc[:, 0]


def bp_topk_ref(scores: torch.Tensor, bias: torch.Tensor, k: int):
    """scores [T, E] float32 gate logits, bias [E] float32 (H / C).
    Returns (idx [T, k] int32, w [T, k] float32)."""
    m = scores.max(dim=1, keepdim=True).values
    e = torch.exp(scores - m)
    probs = e / warp_sum(e)[:, None]
    idx, picked, wsum = _picks(probs, bias, k)
    return idx, picked / torch.clamp(wsum, min=1e-9)[:, None]


def bp_topk_sigmoid_ref(scores: torch.Tensor, bias: torch.Tensor, k: int,
                        scale: float):
    """The sigmoid mode: scores [T, E] float32, bias [E] float32, the
    routed factor ``scale`` (taken as float32).  Returns (idx [T, k] int32,
    w [T, k] float32): the k largest sigmoid(s) - bias, lowest index on
    ties, weighted by their sigmoids over their sum (at least 1e-9) times
    ``scale``."""
    probs = torch.reciprocal(1.0 + torch.exp(-scores))
    idx, picked, wsum = _picks(probs, bias, k)
    w = picked / torch.clamp(wsum, min=1e-9)[:, None]
    return idx, w * torch.tensor(scale, dtype=torch.float32,
                                 device=w.device)


def _picks(probs: torch.Tensor, bias: torch.Tensor, k: int):
    """(idx [T, k] int32, their probs [T, k], the probs' sum [T] in pick
    order): k argmax passes over probs - bias, lowest index on ties."""
    T, E = probs.shape
    dev = probs.device
    work = probs - bias[None, :]
    rows = torch.arange(T, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    picked = torch.empty((T, k), dtype=torch.float32, device=dev)
    wsum = torch.zeros((T,), dtype=torch.float32, device=dev)
    for j in range(k):
        best = torch.argmax(work, dim=1)     # first occurrence on ties
        p = probs[rows, best]
        idx[:, j] = best.to(torch.int32)
        picked[:, j] = p
        wsum = wsum + p
        work[rows, best] = NEG
    return idx, picked, wsum


def bp_topk_route_ref(logits: torch.Tensor, H: torch.Tensor,
                      steps: torch.Tensor, cap: float, k: int,
                      backpressure: bool, score: str = "softmax",
                      scale: float = 1.0):
    """logits [T, E] float32 or bfloat16, H [E] float32, steps [] int32,
    cap the per-step capacity (taken as float32), ``score`` "softmax" or
    "sigmoid" (weights times ``scale``).  Returns (idx [T, k] int64,
    w [T, k] in the logits' dtype, counts [E] float32, H_new [E] float32,
    steps + 1)."""
    T, E = logits.shape
    cap_t = torch.full((), cap, dtype=torch.float32, device=logits.device)
    if backpressure:
        bias = H / torch.clamp(cap_t, min=1.0)
    else:
        bias = torch.zeros((E,), dtype=torch.float32, device=logits.device)
    if score == "sigmoid":
        idx, w = bp_topk_sigmoid_ref(logits.to(torch.float32), bias, k,
                                     scale)
    else:
        idx, w = bp_topk_ref(logits.to(torch.float32), bias, k)
    idx = idx.long()
    # exact integer counts (bincount's), through an op the meta device has
    counts = torch.zeros((E,), dtype=torch.int64, device=idx.device)
    counts = counts.index_add_(0, idx.reshape(-1),
                               torch.ones_like(idx.reshape(-1)))
    counts = counts.to(torch.float32)
    H_new = torch.clamp(H + counts - cap_t, min=0.0)
    return idx, w.to(logits.dtype), counts, H_new, steps + 1
