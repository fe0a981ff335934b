"""Wrappers of the backpressure top-k gate CUDA kernels (bp_topk).

`bp_topk` replaces the Pallas TPU kernel `repro.kernels.bp_topk.kernel.
bp_topk`; its CUDA source is `csrc/bp_topk.cu`.  `bp_topk_route` runs the
whole gate of one MoE layer (`repro.models.moe._route` with
``use_kernel=True``: the bias, that kernel's function, the expert counts
and the H update) in one launch; its source is `csrc/bp_topk_route.cu`.
It also has a sigmoid scoring mode of the port's own (DeepSeek-V3's gate).
Each wrapper checks dtype, shape, device and contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`
    (`bp_topk_route` also for meta tensors, the dry-run's trace, where
    the plain version only carries shapes);
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

``bp_topk.launches`` and ``bp_topk_route.launches`` count CUDA launches
only.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from ..bp_slot.kernel import _check, _raise_on
from .ref import bp_topk_ref, bp_topk_route_ref

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bp_topk.cu"
ROUTE_SOURCE = CSRC / "bp_topk_route.cu"
#: Logits (and weights) dtypes of `bp_topk_route`, by the C entry's code.
ROUTE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Shared memory one block of the fused kernel may use (bytes).
SMEM_LIMIT = 232448


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


def _route_lib() -> ctypes.CDLL:
    lib = _build.load(ROUTE_SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_topk_route.argtypes = [vp, ci, vp, vp, ctypes.c_float, ci, ci,
                                      ctypes.c_float, vp, vp, vp, vp, vp, vp,
                                      ci, ci, ci, vp]
        lib.bp_topk_route.restype = ci
        lib._typed = True
    return lib


#: The fused kernel's int32 workspace ([0] ticket, [1 + e] counts) per
#: (device, stream): allocated once, zeroed; every launch leaves it zero.
_WORKSPACES: dict = {}


def _workspace(dev: torch.device, stream: int, E: int) -> torch.Tensor:
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < 1 + E:
        ws = _WORKSPACES[key] = torch.zeros(1 + E, dtype=torch.int32,
                                            device=dev)
    return ws


#: Scoring modes of `bp_topk_route`, by the C entry's code.
ROUTE_SCORES = {"softmax": 0, "sigmoid": 1}


def bp_topk_route(logits: torch.Tensor, H: torch.Tensor, steps: torch.Tensor,
                  cap: float, k: int, backpressure: bool,
                  score: str = "softmax", scale: float = 1.0):
    """The backpressure gate of one MoE layer.

    logits: [T, E] float32 or bfloat16 router logits; H: [E] float32
    virtual queues; steps: [] int32; cap: the per-step capacity C_e (a
    Python float, taken as float32); ``backpressure``: bias the selection
    by H / max(cap, 1) (else no bias); ``score``: "softmax" (the JAX
    package's gate) or "sigmoid" (DeepSeek-V3's: each logit's sigmoid, the
    weights the picks' sigmoids over their sum times ``scale``, taken as
    float32).  Returns (idx [T, k] int64, w [T, k] in the logits' dtype,
    counts [E] float32, H_new [E] float32, steps + 1), equal bit for bit to
    `ref.bp_topk_route_ref`."""
    if logits.dim() != 2:
        raise ValueError(f"logits: expected [T, E], got {tuple(logits.shape)}")
    T, E = logits.shape
    dev = logits.device
    if logits.dtype not in ROUTE_DTYPES:
        raise TypeError(f"logits: expected float32 or bfloat16, got "
                        f"{logits.dtype}")
    _check("logits", logits, logits.dtype, (T, E), dev)
    _check("H", H, torch.float32, (E,), dev)
    _check("steps", steps, torch.int32, (), dev)
    if T < 1 or not 1 <= k <= E:
        raise ValueError(f"T={T} must be >= 1 and k={k} lie in [1, E={E}]")
    if score not in ROUTE_SCORES:
        raise ValueError(f"score {score!r}: expected one of "
                         f"{sorted(ROUTE_SCORES)}")
    if dev.type in ("cpu", "meta"):     # meta: the dry-run's shapes only
        return bp_topk_route_ref(logits, H, steps, cap, k, backpressure,
                                 score, scale)
    if dev.type != "cuda":
        raise ValueError(f"bp_topk_route: unsupported device {dev}")
    if (E > 256 or k > 32) and 4 * E + 4 * (2 * E + k) > SMEM_LIMIT:
        raise ValueError(f"bp_topk_route: E={E}, k={k} exceed one block's "
                         f"shared memory")
    idx = torch.empty((T, k), dtype=torch.int64, device=dev)
    w = torch.empty((T, k), dtype=logits.dtype, device=dev)
    counts = torch.empty((E,), dtype=torch.float32, device=dev)
    H_new = torch.empty((E,), dtype=torch.float32, device=dev)
    steps_new = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream, E)
        err = _route_lib().bp_topk_route(
            logits.data_ptr(), ROUTE_DTYPES[logits.dtype], H.data_ptr(),
            steps.data_ptr(), ctypes.c_float(cap), int(bool(backpressure)),
            ROUTE_SCORES[score], ctypes.c_float(scale), idx.data_ptr(),
            w.data_ptr(), counts.data_ptr(), H_new.data_ptr(),
            steps_new.data_ptr(), ws.data_ptr(), T, E, k, stream)
    _raise_on(err, "bp_topk_route")
    bp_topk_route.launches += 1
    return idx, w, counts, H_new, steps_new


bp_topk_route.launches = 0
