"""Wrapper of the per-link backpressure routing decision CUDA kernel.

`bp_route_decide` replaces the Pallas TPU kernel `repro.kernels.bp_route.
kernel.bp_route_decide`; its CUDA source is `csrc/bp_route.cu`.  The
wrapper checks dtype, shape, device and contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

The reference pads the links to a multiple of its block; the kernel runs
a group of lanes per link (a warp at C = 96) and needs no padding.  ``bp_route_decide.launches``
counts CUDA launches only.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from ..bp_slot.kernel import _check, _raise_on
from .ref import bp_route_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "bp_route.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_route_decide.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                        vp]
        lib.bp_route_decide.restype = ci
        lib._typed = True
    return lib


def bp_route_decide(qm: torch.Tensor, ql: torch.Tensor, cap: torch.Tensor):
    """qm/ql: [E, C] float32 or bfloat16 backlogs at the two endpoints of
    each link; cap: [E] float32.  Returns (best class [E] int32, rate [E]
    float32, direction [E] int32 with +1 = m -> l), equal bit for bit to
    `ref.bp_route_ref`."""
    if qm.dim() != 2:
        raise ValueError(f"qm: expected [E, C], got {tuple(qm.shape)}")
    E, C = qm.shape
    dev = qm.device
    if qm.dtype not in _DTYPES:
        raise TypeError(f"qm: expected float32 or bfloat16, got {qm.dtype}")
    _check("qm", qm, qm.dtype, (E, C), dev)
    _check("ql", ql, qm.dtype, (E, C), dev)
    _check("cap", cap, torch.float32, (E,), dev)
    if C < 1:
        raise ValueError("qm: needs at least one class column")
    if dev.type == "cpu":
        return bp_route_ref(qm, ql, cap)
    if dev.type != "cuda":
        raise ValueError(f"bp_route_decide: unsupported device {dev}")
    cls = torch.empty((E,), dtype=torch.int32, device=dev)
    rate = torch.empty((E,), dtype=torch.float32, device=dev)
    dirn = torch.empty((E,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().bp_route_decide(
            qm.data_ptr(), ql.data_ptr(), cap.data_ptr(), cls.data_ptr(),
            rate.data_ptr(), dirn.data_ptr(), _DTYPES[qm.dtype], E, C, stream)
    _raise_on(err, "bp_route_decide")
    bp_route_decide.launches += 1
    return cls, rate, dirn


bp_route_decide.launches = 0
