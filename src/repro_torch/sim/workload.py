"""Query-arrival processes and the port's counter-based random numbers.

Port of `repro.sim.workload`.  `torch.Generator` cannot reproduce JAX's
threefry streams, and a stateful generator would make a sim's noise depend
on the batch it runs in.  So every random draw of the port is a pure
integer hash (SplitMix64 on int64 tensors) of

    (the sim's seed, the sim's own slot t, the draw site, the element index)

which gives three properties the fleet engine relies on: a sim's noise
depends only on its own seed and slot, never on its lane or its batch; a
frozen sim (whose slot counter stops) keeps its stream pinned; and the CPU
and the GPU give the same draws bit for bit.  Each draw function below is
one call of `repro_torch.kernels.counter_hash`: on CUDA tensors one launch
of its kernel per [B, n] draw, on CPU tensors the plain int64 chain
(`mix64`, `random_bits`, defined there and re-exported here).

The arrival laws of the reference are here under its names
(`poisson_arrivals`, `bernoulli_batch_arrivals`, `constant_arrivals`),
each returning float32 counts on an explicit device; the fleet's arrival
models turn the same uniforms into the same counts
(`poisson_from_uniform`, `bernoulli_from_uniform`), so a sim's trace and a
fleet lane with its seed draw alike.

Poisson counts come from a per-sim inverse-CDF table built once per run
(each sim's rate is fixed for a run), so a slot's draw is one comparison
against the table instead of a sampling loop.  Each row is padded with 1.0
beyond its own width, so a table may be wider than a row needs (the
graphed chunk of `fleet.engine` sizes it once for the largest rate it may
probe) without changing a draw.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import stats

from repro_torch.device import resolve_device, upload
from repro_torch.kernels.counter_hash.kernel import counter_hash
from repro_torch.kernels.counter_hash.ref import (  # noqa: F401
    _srl, mix64, random_bits)

# Draw sites: one independent stream each.
SITE_ARRIVAL = 1          # Poisson / Bernoulli-batch arrival uniforms
SITE_ARRIVAL_PHASE = 2    # Markov ON-OFF phase flip
SITE_REGULATOR = 3        # regulator B(t), one per comp node
SITE_EVENT_LINK = 4       # link_flaps and Gilbert-Elliott link chains
SITE_EVENT_COMP = 5       # comp_failures and Gilbert-Elliott comp chains
SITE_CLASS_ARRIVAL = 6    # serving traces: each query class's arrival draw
SITE_CLASS_PHASE = 7      # serving traces: each class's ON-OFF phase flip


def uniform(seed: torch.Tensor, t: torch.Tensor, site: int,
            n: int) -> torch.Tensor:
    """[B, n] float32 uniforms in [0, 1) with 24 random bits (exact)."""
    return counter_hash(seed, t, site, n, "uniform")


def uniform64(seed: torch.Tensor, t: torch.Tensor, site: int,
              n: int) -> torch.Tensor:
    """[B, n] float64 uniforms in [0, 1) with 53 random bits (exact)."""
    return counter_hash(seed, t, site, n, "uniform64")


def regulator_bits(seed: torch.Tensor, t: torch.Tensor, eps_b: torch.Tensor,
                   n: int) -> torch.Tensor:
    """[B, n] float32 Bernoulli(eps_b[b]) outcomes of the regulator at each
    sim's slot t[b] (0.0 / 1.0): its `uniform` draw below eps_b[b]."""
    return counter_hash(seed, t, SITE_REGULATOR, n, "bernoulli", eps_b)


def seed_of(seed) -> int:
    """An int seed as it is, or one drawn from a `torch.Generator` (the
    counter-based stream is keyed by an integer either way)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=seed,
                                 device=seed.device))
    return int(seed)


def _slot_uniforms(seed, T: int, dev) -> torch.Tensor:
    """[T] float64 arrival uniforms of slots 0..T-1 under ``seed``."""
    t = torch.arange(T, device=dev)
    s = torch.full((T,), seed_of(seed), dtype=torch.long, device=dev)
    return uniform64(s, t, SITE_ARRIVAL, 1)[:, 0]


# ---------------------------------------------------------------------------
# Arrival laws
# ---------------------------------------------------------------------------

#: Queries per burst of `bernoulli_batch_arrivals` (the reference's default).
BURST = 4

#: Truncation of the Poisson inverse-CDF tables: the mass left beyond the
#: last column is below this.
POISSON_TAIL = 1e-12


def poisson_width(rate: float) -> int:
    """Columns of one Poisson table row at ``rate``: the smallest count
    that leaves less than `POISSON_TAIL` mass beyond the row."""
    return int(poisson_widths([rate])[0])


def poisson_widths(rates) -> np.ndarray:
    """`poisson_width` of each rate, in one call of the distribution's
    inverse survival function (elementwise, so each width is the one a
    rate alone gets)."""
    rates = np.asarray(rates, np.float64).reshape(-1)
    own = np.ones(rates.shape, np.int64)
    pos = rates > 0
    own[pos] = stats.poisson.isf(POISSON_TAIL, rates[pos]).astype(np.int64) + 2
    return own


def poisson_table(rates, device=None, width: int = 0) -> torch.Tensor:
    """[B, K] float64 Poisson CDFs, cdf[b, k] = P(X <= k) for rate[b].

    Row b holds its own `poisson_width(rate[b])` columns and 1.0 beyond
    them (a uniform in [0, 1) never reaches 1.0), so a row, and every draw
    from it, depends on its own rate only, never on the batch it is built
    in.  K is the widest row's width, or ``width`` when that is larger."""
    rates = np.asarray(rates, np.float64).reshape(-1)
    own = poisson_widths(rates)
    K = max(int(own.max()) if rates.size else 1, int(width))
    cols = np.arange(K)[None, :]
    cdf = stats.poisson.cdf(cols, rates[:, None])
    cdf[(cols >= own[:, None]) | (rates[:, None] <= 0)] = 1.0
    return upload(cdf, device, torch.float64)


def poisson_from_uniform(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF Poisson counts: u [B] float64 in [0, 1) against each
    sim's table [B, K] -> [B] float32 counts (#{k : cdf[k] <= u})."""
    return (cdf <= u[:, None]).sum(1).to(torch.float32)


def poisson_arrivals(lams, T: int, seed: int = 0,
                     device=None) -> torch.Tensor:
    """[L, T] Poisson query counts, one row per rate of ``lams``, all rows
    from one uniform stream of ``seed`` (common random numbers), on
    ``device``: CUDA unless the caller asks for the CPU."""
    dev = resolve_device(device)
    cdf = poisson_table(lams, device=dev)
    u = _slot_uniforms(seed, T, dev)                                 # [T]
    return torch.stack([poisson_from_uniform(u, row.expand(T, -1))
                        for row in cdf])


def bernoulli_from_uniform(u: torch.Tensor, lam: torch.Tensor,
                           batch: int = BURST) -> torch.Tensor:
    """Bursts of ``batch`` queries where u < min(lam / batch, 1), else 0
    (float32; ``u`` and ``lam`` broadcast)."""
    p = torch.clamp(lam.to(torch.float32) / batch, max=1.0)
    return (u < p.to(u.dtype)).to(torch.float32) * batch


def bernoulli_batch_arrivals(lam, T: int, seed=0, device=None,
                             batch: int = BURST) -> torch.Tensor:
    """[..., T] arrivals in bursts of ``batch`` at mean rate ``lam`` (a
    scalar or an array of rates; the bursty stress test), from the
    arrival uniforms of ``seed`` (an int or a `torch.Generator`): every
    rate sees the same uniforms, and a fleet lane under the
    ``bernoulli_batch`` model with this seed draws the same trace."""
    dev = resolve_device(device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return bernoulli_from_uniform(_slot_uniforms(seed, T, dev),
                                  lam[..., None], batch)


def constant_arrivals(lam, T: int, device=None) -> torch.Tensor:
    """[..., T] deterministic fluid arrivals, ``lam`` every slot (exact
    capacity checks); it draws nothing, so it takes no seed."""
    dev = resolve_device(device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    return lam[..., None].expand(*lam.shape, T).contiguous()
