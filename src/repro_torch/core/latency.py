"""Streaming sojourn-latency accumulators that ride the serving carry.

Port of `repro.core.latency`, batched over a leading fleet axis [B].  The
serving engine scores latency under the fleet engine's O(1)-memory
contract: no [T]-shaped arrays and no per-query timestamps (queries are
fluid).  Each sim carries

  * a ring of its cumulative-admitted curve A(s) over the last `horizon`
    slots, and
  * a delivered-weighted histogram of sojourn delays.

Under FIFO fluid service the sojourn of the flow departing at slot t is
the horizontal distance between the cumulative curves, one comparison over
the ring: ``sum(ring > D(t))``.  Slots older than the ring report the cap
(`horizon`); slots before the run started hold A = 0 and add nothing.
Quantiles read the histogram's running-sum crossing and report the bin's
upper edge; the delay sum of the mean is Kahan-compensated.

The sim's slot counter ``t`` is [B], so the ring write at ``t % horizon``
is a per-sim index, and the histogram add one ``scatter_add`` of one
element per row.  Every update is elementwise float32 in the reference's
order (its Kahan step's product fused as the reference's program fuses
it), so `latency_update` is bit-exact against the reference on the same
inputs.  The sums over a histogram in
`latency_quantiles` and `latency_mean` run in torch's order, which is not
XLA's: on the same histogram they agree with the reference to rounding of
those sums (bit for bit wherever the sums are exact).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch



@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """O(horizon + n_bins) latency state of every sim.

    ``ring[b, s]`` holds sim b's cumulative admitted mass at the end of
    slot s (mod `horizon`); ``hist[b, k]`` the delivered mass whose sojourn
    fell in bin k, bin ``n_bins`` collecting everything at or past the cap.
    """

    ring: torch.Tensor        # [B, horizon] float32
    hist: torch.Tensor        # [B, n_bins + 1] float32
    sum_delay: torch.Tensor   # [B] delivered-weighted delay sum
    c_delay: torch.Tensor     # [B] Kahan compensation of sum_delay

    @staticmethod
    def zero(B: int, horizon: int, n_bins: int, device) -> "LatencyStats":
        f = dict(dtype=torch.float32, device=device)
        return LatencyStats(ring=torch.zeros((B, horizon), **f),
                            hist=torch.zeros((B, n_bins + 1), **f),
                            sum_delay=torch.zeros((B,), **f),
                            c_delay=torch.zeros((B,), **f))


def latency_update(lat: LatencyStats, t: torch.Tensor,
                   cum_admitted: torch.Tensor, cum_delivered: torch.Tensor,
                   delivered_slot: torch.Tensor, *, horizon: int,
                   n_bins: int) -> LatencyStats:
    """One slot of every sim's accumulator (post-slot cumulative counters,
    each [B]; ``t`` [B] the sims' slot indices).  The FIFO sojourn of the
    mass delivered this slot is the count of ring slots whose admitted
    curve still exceeds today's delivered curve; a strict ``>`` makes an
    empty system report zero delay."""
    pos = (t % horizon).long()[:, None]
    ring = lat.ring.scatter(1, pos, cum_admitted[:, None])
    delay = (ring > cum_delivered[:, None]).sum(-1).to(torch.float32)
    bin_w = max(horizon // n_bins, 1)
    b = torch.clamp(delay / bin_w, max=n_bins).to(torch.int64)[:, None]
    # Kahan's first step, y = delay * delivered - c, as one fused
    # multiply-add: the reference's XLA program contracts it so (one
    # rounding; float64 holds the product exactly).
    y = (delay.double() * delivered_slot.double()
         - lat.c_delay.double()).to(torch.float32)
    s = lat.sum_delay + y
    c = (s - lat.sum_delay) - y
    return LatencyStats(ring=ring,
                        hist=lat.hist.scatter_add(1, b,
                                                  delivered_slot[:, None]),
                        sum_delay=s, c_delay=c)


def latency_quantiles(hist: torch.Tensor, qs: Sequence[float], *,
                      horizon: int, n_bins: int) -> torch.Tensor:
    """Histogram quantiles in slots, as bin upper edges: [..., len(qs)].

    Works on any histogram of the `LatencyStats.hist` layout, a run's or a
    difference of two snapshots.  An all-zero histogram reports 0."""
    hist = hist.to(torch.float32)
    total = hist.sum(-1, keepdim=True)
    cum = torch.cumsum(hist, -1)
    bin_w = max(horizon // n_bins, 1)
    out = []
    for q in qs:
        b = (cum < q * total).sum(-1)                # first bin crossing q
        edge = torch.clamp((b + 1) * bin_w, max=horizon).to(torch.float32)
        out.append(torch.where(total[..., 0] > 0, edge,
                               torch.zeros_like(edge)))
    return torch.stack(out, -1)


def latency_mean(lat: LatencyStats) -> torch.Tensor:
    """Delivered-weighted mean sojourn in slots, [B] (0 if nothing was
    delivered)."""
    total = lat.hist.sum(-1)
    return torch.where(total > 0,
                       lat.sum_delay / torch.clamp(total, min=1e-9),
                       torch.zeros_like(total))
