"""Wrapper of the fused backpressure top-k gate CUDA kernel (bp_topk).

`bp_topk` replaces the Pallas TPU kernel `repro.kernels.bp_topk.kernel.
bp_topk`; its CUDA source is `csrc/bp_topk.cu`.  The wrapper checks dtype,
shape, device and contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

``bp_topk.launches`` counts CUDA launches only.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from ..bp_slot.kernel import _check, _raise_on
from .ref import bp_topk_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "bp_topk.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_topk.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.bp_topk.restype = ci
        lib.bp_topk_max_experts.argtypes = []
        lib.bp_topk_max_experts.restype = ci
        lib._typed = True
    return lib


def bp_topk(scores: torch.Tensor, bias: torch.Tensor, k: int):
    """scores: [T, E] float32 gate logits; bias: [E] float32 (beta*H/C).

    Returns (idx [T, k] int32, w [T, k] float32): the k experts of largest
    ``softmax(scores) - bias`` per row, lowest index on ties, and their
    unbiased gate probabilities renormalised.  Equal bit for bit to
    `ref.bp_topk_ref`."""
    if scores.dim() != 2:
        raise ValueError(f"scores: expected [T, E], got {tuple(scores.shape)}")
    T, E = scores.shape
    dev = scores.device
    _check("scores", scores, torch.float32, (T, E), dev)
    _check("bias", bias, torch.float32, (E,), dev)
    if not 1 <= k <= E:
        raise ValueError(f"k={k} must lie in [1, E={E}]")
    if dev.type == "cpu":
        return bp_topk_ref(scores, bias, k)
    if dev.type != "cuda":
        raise ValueError(f"bp_topk: unsupported device {dev}")
    lib = _lib()
    if E > lib.bp_topk_max_experts():
        raise ValueError(f"bp_topk: E={E} exceeds the kernel's shared-memory "
                         f"limit of {lib.bp_topk_max_experts()} experts")
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bp_topk(scores.data_ptr(), bias.data_ptr(), idx.data_ptr(),
                          w.data_ptr(), T, E, k, stream)
    _raise_on(err, "bp_topk")
    bp_topk.launches += 1
    return idx, w


bp_topk.launches = 0
