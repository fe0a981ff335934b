"""Wrapper of the counter-based noise kernel (counter_hash).

`counter_hash` computes a whole [B, n] draw of the port's noise (see
`repro_torch.sim.workload`) in one launch of `csrc/counter_hash.cu`; its
plain version is `ref.counter_hash_ref`.  The draw functions of `workload`
pick the output form.  The wrapper checks device, dtype, shape and
contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

Launches count in plain integer attributes, CUDA launches only:
``counter_hash.launches`` for eager calls, ``counter_hash.captured`` for
calls made while the stream is captured into a CUDA graph; the graph's
owner (`repro_torch.fleet.capture.CapturedSlots`) adds the launches of its
replays to ``counter_hash.replayed``.  A CUDA caller must make its first
call outside a capture, so that the library is loaded before one.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from .ref import FORMS, counter_hash_ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "counter_hash.cu"
#: Output dtype of each form.
DTYPES = {"uniform": torch.float32, "uniform64": torch.float64,
          "bernoulli": torch.float32}
#: The C entry takes B * n as an int; the kernel indexes elements with
#: 32-bit unsigned ints.
MAX_ELEMENTS = 2 ** 31 - 1


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.counter_hash.argtypes = [vp, vp, ci, vp, vp, ci, ci,
                                     ctypes.c_longlong, ci, vp]
        lib.counter_hash.restype = ci
        lib._typed = True
    return lib


def _check(name: str, x: torch.Tensor, dtypes, B: int, device) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, "
                        f"got {x.dtype}")
    if tuple(x.shape) != (B,):
        raise ValueError(f"{name}: expected shape ({B},), got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def counter_hash(seed: torch.Tensor, t: torch.Tensor, site: int, n: int,
                 form: str, eps: torch.Tensor | None = None) -> torch.Tensor:
    """[B, n] draws of ``site`` at each sim's slot: seed [B] int64, t [B]
    int32 or int64, ``form`` one of `ref.FORMS`, eps [B] float32 for the
    ``bernoulli`` form.  Equal bit for bit to `ref.counter_hash_ref`."""
    if form not in FORMS:
        raise ValueError(f"unknown output form {form!r}")
    if seed.dim() != 1:
        raise ValueError(f"seed: expected [B], got {tuple(seed.shape)}")
    B, dev = seed.shape[0], seed.device
    _check("seed", seed, (torch.int64,), B, dev)
    _check("t", t, (torch.int32, torch.int64), B, dev)
    if form == "bernoulli":
        if eps is None:
            raise ValueError("the bernoulli form needs eps")
        _check("eps", eps, (torch.float32,), B, dev)
    if not 0 <= int(site) < 2 ** 63:
        raise ValueError(f"site {site} outside 0..2**63-1")
    if not (0 <= n and B * n <= MAX_ELEMENTS):
        raise ValueError(f"a draw of [{B}, {n}] outside 0..{MAX_ELEMENTS} "
                         f"elements")
    if dev.type == "cpu":
        return counter_hash_ref(seed, t, site, n, form, eps)
    if dev.type != "cuda":
        raise ValueError(f"counter_hash: unsupported device {dev}")
    out = torch.empty((B, n), dtype=DTYPES[form], device=dev)
    if B * n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().counter_hash(
                seed.data_ptr(), t.data_ptr(), t.element_size(),
                eps.data_ptr() if form == "bernoulli" else None,
                out.data_ptr(), B, n, int(site), FORMS.index(form), stream)
        if err != 0:
            raise RuntimeError(f"counter_hash: CUDA launch failed with error "
                               f"{err}")
        if torch.cuda.is_current_stream_capturing():
            counter_hash.captured += 1
        else:
            counter_hash.launches += 1
    return out


counter_hash.launches = 0
counter_hash.captured = 0
counter_hash.replayed = 0
