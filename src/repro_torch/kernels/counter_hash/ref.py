"""Plain PyTorch version of the port's counter-based noise.

Every random draw of the port is SplitMix64 on int64 tensors (wrapping
arithmetic) of (a sim's seed, its slot t, the draw site, the element
index); `repro_torch.sim.workload` documents the stream and names the
sites.  `counter_hash_ref` is the function the CUDA kernel
`csrc/counter_hash.cu` computes, in the three output forms the draw
functions take: ``uniform`` (float32, 24 random bits), ``uniform64``
(float64, 53 bits) and ``bernoulli`` (float32 0.0 / 1.0 where the
``uniform`` draw is below the sim's probability).  Every step is integer
arithmetic or an exact conversion, so the kernel equals it bit for bit.

`mix64`, `_srl` and `random_bits` are defined here, not in `sim`, because
kernels/ never imports sim/; `workload` re-exports them under its names.
"""
from __future__ import annotations

import torch


def _signed(x: int) -> int:
    """A 64-bit constant as the int64 value with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


_GAMMA = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)

#: The output forms, in the order of `Form` in csrc/counter_hash.cu.
FORMS = ("uniform", "uniform64", "bernoulli")


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer on int64 tensors (wrapping arithmetic)."""
    z = (z ^ _srl(z, 30)) * _M1
    z = (z ^ _srl(z, 27)) * _M2
    return z ^ _srl(z, 31)


def random_bits(seed: torch.Tensor, t: torch.Tensor, site: int,
                n: int) -> torch.Tensor:
    """[B, n] int64 hash of (seed[b], t[b], site, element index)."""
    base = mix64(seed.long() * _GAMMA + site)
    base = mix64(base + (t.long() + 1) * _GAMMA)
    idx = torch.arange(1, n + 1, dtype=torch.long, device=base.device)
    return mix64(base[:, None] + idx[None, :] * _GAMMA)


def counter_hash_ref(seed: torch.Tensor, t: torch.Tensor, site: int, n: int,
                     form: str, eps: torch.Tensor | None = None):
    """[B, n] draws of ``site`` at each sim's slot t[b] in ``form``:
    float32 uniforms in [0, 1) (``uniform``), float64 ones (``uniform64``),
    or float32 Bernoulli(eps[b]) outcomes of the float32 uniforms
    (``bernoulli``)."""
    bits = random_bits(seed, t, site, n)
    if form == "uniform64":
        return _srl(bits, 11).to(torch.float64) * (2.0 ** -53)
    u = _srl(bits, 40).to(torch.float32) * (2.0 ** -24)
    if form == "uniform":
        return u
    if form == "bernoulli":
        return (u < eps[:, None]).to(torch.float32)
    raise ValueError(f"unknown output form {form!r}")
