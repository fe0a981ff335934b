"""Wrapper of the flash attention CUDA kernels.

`flash_attention` replaces the Pallas TPU kernel `repro.kernels.
flash_attention.kernel.flash_attention`.  The wrapper checks shapes,
dtypes, device and strides, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches one of two kernels (building it at first
    use, see `repro_torch.kernels._build`) or raises.  There is no
    fallback from one kernel to the other or to the plain version.

The kernel is chosen by dtype and head dims only (q and k have one head
dim, D; v has its own, Dv, which is D unless said):

  * bfloat16 with D in {64, 80, 128}: `csrc/flash_attention_sm90.cu`,
    both products on the bf16 tensor cores (wgmma, K/V staged by TMA),
    128-query x 64- or 128-key tiles; D = 80 runs the D = 128 kernel over
    tensor maps 80 columns wide (TMA fills the rest of the tile with
    zeros, and the store is bounded to 80 columns), so q, k and v are
    passed as they are, with no padded copy;
  * bfloat16 with (D, Dv) = (192, 128), the latent attention (MLA) of
    DeepSeek-V3's block: the same kernel's (192, 128) instance, scores
    scaled by 1/sqrt(192); float32 at these dims is refused (its training
    is not ported);
  * float32 (D in {16, 32, 64, 80, 128}) and bfloat16 with D in {16, 32}:
    `csrc/flash_attention.cu`, the CUDA-core kernel: one CTA of 256
    threads per (batch row, kv head, query block) covering up to 8 of the
    query heads that share the kv head (128 (head, query) rows), register
    tiles of 4 rows x 4 keys (S) and 4 rows x D/8 dims (O) per thread, and
    32-key K/V tiles through a 2-stage ring of ``cp.async`` copies.

With T = 0 no row has a key, and with an empty q there is no row: the
wrapper then returns zeros without a launch, whatever the dtype.  Both kernels take any S and T >= 1 and read q, k and v
through their batch, head and sequence strides with the head dim
contiguous, so a [B, S, H, D] tensor passes as its ``transpose(1, 2)`` view
without a copy; the output takes q's strides (`torch.empty_like`; with
Dv != D, `_out`'s [B, S, H, Dv] layout).  Both
read rows in 16-byte pieces: the sm90 kernel through TMA tensor maps
(`tma_ready`), the CUDA-core kernel by ``cp.async`` and vector loads
(`async_copy_ready`); each needs a 16-byte aligned base and strides of a
multiple of 16 bytes, and an input that lacks either is first copied into
a contiguous clone (the model's projections never are).  The kernels
themselves never fall back to another kernel or to the plain version.

``flash_attention.launches`` counts launches of the CUDA-core kernel and
``flash_attention.launches_sm90`` those of the sm90 kernel; a CPU call
counts none.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build
from ..bp_slot.kernel import _raise_on
from .ref import flash_attention_ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"            # the CUDA-core kernel
SOURCE_SM90 = CSRC / "flash_attention_sm90.cu"  # the tensor-core kernel
#: Head dims each kernel instantiates, by dtype.
HEAD_DIMS = {torch.float32: (16, 32, 64, 80, 128), torch.bfloat16: (16, 32)}
#: (q/k, v) head dims of the sm90 kernel's instances, bfloat16 only.
HEAD_DIMS_SM90 = ((64, 64), (80, 80), (128, 128), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float, vp]
        lib.flash_attention_fwd.restype = ci
        lib.flash_attention_occupancy.argtypes = [
            ci, ci, ctypes.POINTER(ci)]
        lib.flash_attention_occupancy.restype = ci
        lib._typed = True
    return lib


def _lib_sm90() -> ctypes.CDLL:
    lib = _build.load(SOURCE_SM90)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_sm90_fwd.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ctypes.POINTER(ctypes.c_longlong), ci, ci, ctypes.c_float, vp]
        lib.flash_attention_sm90_fwd.restype = ci
        lib._typed = True
    return lib


def uses_sm90(dtype: torch.dtype, head_dim: int,
              v_dim: int | None = None) -> bool:
    """Whether a CUDA call of this dtype and q/k head dim (and v head dim,
    ``head_dim`` unless given) runs the sm90 kernel (else the CUDA-core
    kernel)."""
    dims = (head_dim, head_dim if v_dim is None else v_dim)
    return dtype == torch.bfloat16 and dims in HEAD_DIMS_SM90


def kernel_for(dtype: torch.dtype, head_dim: int,
               v_dim: int | None = None) -> str:
    """The kernel a CUDA call of this dtype and head dims launches: "sm90"
    or "cuda-core"; ValueError for head dims that neither instantiates
    (the CUDA-core kernel takes v's head dim equal to q's only)."""
    if uses_sm90(dtype, head_dim, v_dim):
        return "sm90"
    if v_dim in (None, head_dim) and head_dim in HEAD_DIMS[dtype]:
        return "cuda-core"
    dims = (f"head dim {head_dim}" if v_dim in (None, head_dim) else
            f"head dims q/k {head_dim}, v {v_dim}")
    raise ValueError(f"flash_attention: {dims} in {dtype} is not one of "
                     f"the kernels' {HEAD_DIMS[dtype]} or, in bfloat16, "
                     f"(q/k, v) {HEAD_DIMS_SM90}")


def async_copy_ready(t: torch.Tensor) -> bool:
    """A 16-byte aligned tensor whose batch, head and sequence strides are
    multiples of 16 bytes, where the dim is longer than 1: rows that the
    CUDA-core kernel's 16-byte copies and loads can read (its head dims
    make every row a whole number of 16-byte pieces)."""
    n = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s % n == 0 for s, m in zip(t.stride()[:3], t.shape[:3]) if m > 1)


def tma_ready(t: torch.Tensor) -> bool:
    """`async_copy_ready` with positive strides: what a TMA tensor map can
    describe (the sm90 kernel's bf16 inputs)."""
    return async_copy_ready(t) and all(
        s > 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def occupancy(dtype: torch.dtype, head_dim: int) -> int:
    """CTAs of the CUDA-core kernel's (dtype, head dim) instantiation that
    fit on one SM of the current card at once (CUDA only)."""
    ctas = ctypes.c_int(0)
    _raise_on(_lib().flash_attention_occupancy(
        _DTYPES[dtype], head_dim, ctypes.byref(ctas)),
        "flash_attention_occupancy")
    return ctas.value


def _map_strides(t: torch.Tensor):
    """t's (batch, head, sequence) strides, 8 for a dim of length 1 (whose
    stride no address uses, and which a tensor map still checks)."""
    return tuple(s if n > 1 else 8
                 for s, n in zip(t.stride()[:3], t.shape[:3]))


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: expected float32 or bfloat16 like q, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.stride(-1) != 1 and t.numel():      # empty: no layout to read
            raise ValueError(f"{name}: the head dim must be contiguous")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KH, T, D) or tuple(v.shape[:3]) != (B, KH, T) \
            or v.shape[3] < 1:
        raise ValueError(f"k/v: expected [B, KH, T, D] = {(B, KH, T, D)} "
                         f"and [B, KH, T, Dv], got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads over {KH} kv heads")


def _out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An uninitialised output [B, H, S, dv] in q's dtype: q's strides when
    dv is q's head dim, else heads inside the sequence as in a
    [B, S, H, dv] tensor's ``transpose(1, 2)`` view."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    B, H, S, _ = q.shape
    return q.new_empty((B, S, H, dv)).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q [B, H, S, D], k [B, KH, T, D], v [B, KH, T, Dv] (float32 or
    bfloat16, head dim contiguous) -> [B, H, S, Dv] in q's dtype: causal
    GQA attention with an optional sliding window, scores scaled by
    1/sqrt(D), float32 math (see `ref.flash_attention_ref`).  On CUDA,
    bfloat16 with (D, Dv) in `HEAD_DIMS_SM90` runs the sm90 kernel and the
    other instantiated head dims (Dv = D) the CUDA-core kernel (see the
    module's docstring); any other head dims raise."""
    _check(q, k, v)
    if window is not None and window < 0:
        raise ValueError(f"window={window} must be None or >= 0")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, H, S, D = q.shape
    KH, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    sm90 = kernel_for(q.dtype, D, Dv) == "sm90"
    if T == 0 or q.numel() == 0:     # no key for any row, or no row: 0
        return _out(q, Dv).zero_()
    if sm90:
        return _flash_sm90(q, k, v, causal=causal, window=window)
    q, k, v = (t if async_copy_ready(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)     # q's strides, or contiguous: aligned too
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


def _flash_sm90(q, k, v, *, causal, window):
    """The sm90 kernel on CUDA bfloat16 tensors with (D, Dv) in
    HEAD_DIMS_SM90."""
    B, H, S, D = q.shape
    KH, T, Dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = (t if tma_ready(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = _out(q, Dv)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v) for s in _map_strides(t)),
        *out.stride()[:3])
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib_sm90().flash_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KH, S, T, D, Dv, strides, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            stream)
    _raise_on(err, "flash_attention (sm90)")
    flash_attention.launches_sm90 += 1
    return out


flash_attention.launches = 0
flash_attention.launches_sm90 = 0
