"""Wrappers of the fleet-batched slot-decision CUDA kernels (bp_slot).

`slot_route_decide` and `comp_balance_decide` replace the two Pallas TPU
kernels of `repro.kernels.bp_slot.kernel`; their CUDA source is
`csrc/bp_slot.cu`.  Each wrapper checks device, dtype, shape and
contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

Each wrapper counts its kernel launches in a plain integer attribute
(``slot_route_decide.launches``, ``comp_balance_decide.launches``), so a run
can show that its main path went through the kernels.  Only CUDA launches
count.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from .ref import PANELS, comp_balance_ref, slot_route_ref

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "bp_slot.cu"


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_slot_route_decide.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                             ci, vp]
        lib.bp_slot_route_decide.restype = ci
        lib.bp_slot_comp_balance_decide.argtypes = [vp, vp, vp, vp, ci, ci,
                                                    ci, ci, ctypes.c_float,
                                                    vp]
        lib.bp_slot_comp_balance_decide.restype = ci
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def slot_route_decide(Qf: torch.Tensor, m_idx: torch.Tensor,
                      l_idx: torch.Tensor):
    """Qf: [B, N, C] float32 flattened class backlogs (i-major);
    m_idx/l_idx: [B, E] int32 endpoints.  Returns (best [B, E] int32 flat
    class index, dmax [B, E] float32 signed differential), equal bit for
    bit to `ref.slot_route_ref`."""
    if Qf.dim() != 3:
        raise ValueError(f"Qf: expected [B, N, C], got {tuple(Qf.shape)}")
    B, N, C = Qf.shape
    E = m_idx.shape[-1]
    dev = Qf.device
    _check("Qf", Qf, torch.float32, (B, N, C), dev)
    _check("m_idx", m_idx, torch.int32, (B, E), dev)
    _check("l_idx", l_idx, torch.int32, (B, E), dev)
    if C < 1:
        raise ValueError("Qf: needs at least one class column")
    if dev.type == "cpu":
        return slot_route_ref(Qf, m_idx, l_idx)
    if dev.type != "cuda":
        raise ValueError(f"slot_route_decide: unsupported device {dev}")
    best = torch.empty((B, E), dtype=torch.int32, device=dev)
    dmax = torch.empty((B, E), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().bp_slot_route_decide(
            Qf.data_ptr(), m_idx.data_ptr(), l_idx.data_ptr(),
            best.data_ptr(), dmax.data_ptr(), B, N, C, E, stream)
    _raise_on(err, "slot_route_decide")
    slot_route_decide.launches += 1
    return best, dmax


slot_route_decide.launches = 0


def comp_balance_decide(eps, q0, q1, q2, H, caps, mask, x1, x2, ca1, ca2, cc,
                        x_net, *, pairing: str = "fifo",
                        thresholded: bool = False, threshold: float = 0.0):
    """Per-comp-node decision for every sim: ``eps`` [B] float32 and twelve
    [B, NC] float32 panels.  Returns (Z [B, NC] float32, n_star [B] int32),
    equal bit for bit to `ref.comp_balance_ref`.

    For the CUDA kernel the panels are stacked into one contiguous
    [B, 12, NC] tensor in `ref.PANELS` order (a layout choice: one sim's
    inputs become one contiguous run)."""
    if pairing not in ("fifo", "bound"):
        raise ValueError(f"unknown pairing model {pairing!r}")
    panels = (q0, q1, q2, H, caps, mask, x1, x2, ca1, ca2, cc, x_net)
    B, NC = q0.shape
    dev = eps.device
    _check("eps", eps, torch.float32, (B,), dev)
    for name, p in zip(PANELS, panels):
        if p.dtype != torch.float32 or tuple(p.shape) != (B, NC) or \
                p.device != dev:
            raise ValueError(f"{name}: expected float32 [{B}, {NC}] on {dev}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    if dev.type == "cpu":
        return comp_balance_ref(eps, *panels, pairing=pairing,
                                thresholded=thresholded, threshold=threshold)
    if dev.type != "cuda":
        raise ValueError(f"comp_balance_decide: unsupported device {dev}")
    stacked = torch.stack(panels, dim=1)                # [B, 12, NC]
    eps = eps.contiguous()
    Z = torch.empty((B, NC), dtype=torch.float32, device=dev)
    n_star = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().bp_slot_comp_balance_decide(
            eps.data_ptr(), stacked.data_ptr(), Z.data_ptr(),
            n_star.data_ptr(), B, NC, int(pairing == "bound"),
            int(bool(thresholded)), float(threshold), stream)
    _raise_on(err, "comp_balance_decide")
    comp_balance_decide.launches += 1
    return Z, n_star


comp_balance_decide.launches = 0
