"""The counter-based random numbers of the system under test, worked out
again in NumPy: SplitMix64 over unsigned 64-bit integers (which wrap, as the
hash wants), keyed by (seed, the lane's own slot t, draw site, element).

Each draw of the program is a pure function of those four numbers, so the
reference gets the same uniforms from the same seeds without reading
anything the program made.
"""
from __future__ import annotations

import numpy as np

SITE_ARRIVAL = 1          # Poisson / Bernoulli-batch arrival uniforms
SITE_REGULATOR = 3        # the regulator's B(t), one per comp node
SITE_EVENT_LINK = 4       # Gilbert-Elliott link chains, link flaps
SITE_EVENT_COMP = 5       # Gilbert-Elliott comp chains, comp failures

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def random_bits(seed, t, site: int, n: int) -> np.ndarray:
    """[B, n] uint64 hash of (seed[b], t[b], site, element 1..n)."""
    seed = np.asarray(seed, np.int64).astype(np.uint64).reshape(-1)
    t = np.asarray(t, np.int64).astype(np.uint64).reshape(-1)
    with np.errstate(over="ignore"):
        base = _mix64(seed * _GAMMA + np.uint64(site))
        base = _mix64(base + (t + np.uint64(1)) * _GAMMA)
        idx = np.arange(1, n + 1, dtype=np.uint64)
        return _mix64(base[:, None] + idx[None, :] * _GAMMA)


def uniform(seed, t, site: int, n: int) -> np.ndarray:
    """[B, n] float32 uniforms in [0, 1) with 24 random bits."""
    bits = random_bits(seed, t, site, n) >> np.uint64(40)
    return bits.astype(np.float32) * np.float32(2.0 ** -24)


def uniform64(seed, t, site: int, n: int) -> np.ndarray:
    """[B, n] float64 uniforms in [0, 1) with 53 random bits."""
    bits = random_bits(seed, t, site, n) >> np.uint64(11)
    return bits.astype(np.float64) * (2.0 ** -53)
