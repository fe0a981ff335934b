"""Wrapper of the flash attention CUDA kernel.

`flash_attention` replaces the Pallas TPU kernel `repro.kernels.
flash_attention.kernel.flash_attention`; its CUDA source is
`csrc/flash_attention.cu`.  The wrapper checks shapes, dtypes, device and
strides, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

q, k and v may have any strides with the head dim contiguous: the kernel
reads them through their batch, head and sequence strides, so a
[B, S, H, D] tensor passes as its ``transpose(1, 2)`` view without a copy,
and the output takes q's strides (`torch.empty_like`).  The kernel's tile
is fixed at 64 queries x 64 keys and takes any S and T.

``flash_attention.launches`` counts CUDA launches only.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build
from ..bp_slot.kernel import _raise_on
from .ref import flash_attention_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)   # head dims the source instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float, vp]
        lib.flash_attention_fwd.restype = ci
        lib._typed = True
    return lib


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: expected float32 or bfloat16 like q, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KH, T, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v: expected [B, KH, T, D] = {(B, KH, T, D)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads over {KH} kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KH, T, D] (float32 or bfloat16, head dim
    contiguous) -> [B, H, S, D] in q's dtype: causal GQA attention with an
    optional sliding window, float32 math (see `ref.flash_attention_ref`)."""
    _check(q, k, v)
    if window is not None and window < 0:
        raise ValueError(f"window={window} must be None or >= 0")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, KH, S, T, D, strides, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
