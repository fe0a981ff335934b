"""Wrappers of the fleet-batched slot CUDA kernels (bp_slot).

`slot_route_decide` and `comp_balance_decide` replace the two Pallas TPU
kernels of `repro.kernels.bp_slot.kernel`; their CUDA source is
`csrc/bp_slot.cu`.  `slot_step_fused` runs the whole slot step (both
decisions and everything around them, `repro.core.policies.slot_step`) of
every sim in one launch; its source is `csrc/bp_slot_step.cu`, and its
plain version `ref.slot_step_plain`.  Both sources make their decisions
with the device functions of `csrc/bp_slot_decide.cuh`.  Each wrapper
checks device, dtype, shape and contiguity, then:

  * for CPU tensors, runs the plain PyTorch version in `ref.py`;
  * for CUDA tensors, launches the kernel (building it at first use, see
    `repro_torch.kernels._build`) or raises — there is no fallback.

Each wrapper counts its kernel launches in a plain integer attribute
(``slot_route_decide.launches``, ``comp_balance_decide.launches``,
``slot_step_fused.launches``), so a run can show that its main path went
through the kernels.  Only CUDA launches count.  The fused slot step also
runs inside the CUDA graphs of `repro_torch.fleet.engine.GroupLaunch`: a
call made while its stream is being captured launches nothing and counts
in ``slot_step_fused.captured``; each replay of such a graph launches the
kernels it captured, and the graph's owner adds them to
``slot_step_fused.replayed``.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build
from .ref import (PANELS, PROBLEM_LEAVES, STATE_LEAVES, comp_balance_ref,
                  slot_route_ref, slot_step_plain)

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bp_slot.cu"
STEP_SOURCE = CSRC / "bp_slot_step.cu"


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


# ---------------------------------------------------------------------------
# slot_step_fused
# ---------------------------------------------------------------------------

#: ``SlotStepArgs`` of bp_slot_step.cu: pointer fields in its order.
_STEP_POINTERS = (
    STATE_LEAVES + PROBLEM_LEAVES + ("arrivals", "reg_draws", "eps_b")
    + tuple("o_" + k for k in STATE_LEAVES)
    + ("total_queue", "routed", "computed", "Z", "n_star"))
_STEP_INTS = ("B", "N", "NC", "E", "load_balance", "fixed_node", "regulated",
              "pairing_bound", "thresholded", "wireless")
#: What bp_slot_step returns when a sim does not fit one block.
_TOO_LARGE = -1


class _SlotStepArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _STEP_POINTERS]
                + [(k, ctypes.c_int) for k in _STEP_INTS]
                + [("threshold", ctypes.c_float)])


def _step_lib() -> ctypes.CDLL:
    lib = _build.load(STEP_SOURCE)
    if not getattr(lib, "_typed", False):
        lib.bp_slot_step.argtypes = [ctypes.POINTER(_SlotStepArgs),
                                     ctypes.c_void_p]
        lib.bp_slot_step.restype = ctypes.c_int
        lib.bp_slot_step_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.bp_slot_step_smem_bytes.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def _step_shapes(B, N, NC, E):
    """Expected (dtype, shape) of every input leaf."""
    f, i = torch.float32, torch.int32
    return {
        "Q": (f, (B, N, 3, NC)), "Ddum": (f, (B, N, NC)), "X": (f, (B, NC, 2)),
        "Y": (f, (B, NC)), "H": (f, (B, NC)), "cum_arr": (f, (B, NC, 2)),
        "cum_comb": (f, (B, NC)), "delivered": (f, (B,)),
        "delivered_useful": (f, (B,)), "delivered_c": (f, (B,)),
        "delivered_useful_c": (f, (B,)),
        "edges": (i, (B, E, 2)), "edge_cap": (f, (B, E)), "s1": (i, (B,)),
        "s2": (i, (B,)), "dest": (i, (B,)), "comp_nodes": (i, (B, NC)),
        "comp_caps": (f, (B, NC)), "sink": (torch.bool, (B, N, 3, NC)),
        "edge_mask": (f, (B, E)), "comp_mask": (f, (B, NC)),
        "arrivals": (f, (B,)), "reg_draws": (f, (B, NC)), "eps_b": (f, (B,)),
    }


def slot_step_fused(state: dict, problem: dict, arrivals: torch.Tensor,
                    reg_draws, eps_b: torch.Tensor, *, load_balance: bool,
                    fixed_node: int, regulated: bool, pairing: str,
                    thresholded: bool, threshold: float, wireless: bool):
    """One slot step of every sim of the batch: on CUDA tensors one launch
    of the fused kernel, on CPU tensors `ref.slot_step_plain`.

    ``state``: the STATE_LEAVES (float32, Q [B, N, 3, NC], Ddum [B, N, NC],
    X and cum_arr [B, NC, 2], Y, H and cum_comb [B, NC], the four delivery
    counters [B]); ``problem``: the PROBLEM_LEAVES of a `PaddedProblem`;
    arrivals [B] and eps_b [B] float32; reg_draws [B, NC] float32 (needed
    when ``regulated``, else ignored and may be None).  The flags are those
    of `ref.slot_step_plain`.  Returns (new state dict, metrics) as
    `ref.slot_step_plain` does; the inputs are not modified."""
    if pairing not in ("fifo", "bound"):
        raise ValueError(f"unknown pairing model {pairing!r}")
    Q = state["Q"]
    if Q.dim() != 4 or Q.shape[2] != 3:
        raise ValueError(f"Q: expected [B, N, 3, NC], got {tuple(Q.shape)}")
    B, N, _, NC = Q.shape
    edges = problem["edges"]
    if edges.dim() != 3:
        raise ValueError(f"edges: expected [B, E, 2], got "
                         f"{tuple(edges.shape)}")
    E = edges.shape[1]
    if not load_balance and not 0 <= fixed_node < NC:
        raise ValueError(f"fixed_node {fixed_node} outside 0..{NC - 1}")
    if regulated and reg_draws is None:
        raise ValueError("a regulated policy needs regulator draws")
    dev = Q.device
    inputs = {**{k: state[k] for k in STATE_LEAVES},
              **{k: problem[k] for k in PROBLEM_LEAVES},
              "arrivals": arrivals, "eps_b": eps_b}
    if regulated:
        inputs["reg_draws"] = reg_draws
    for k, (dtype, shape) in _step_shapes(B, N, NC, E).items():
        if k in inputs:
            _check(k, inputs[k], dtype, shape, dev)
    flags = dict(load_balance=bool(load_balance), fixed_node=int(fixed_node),
                 regulated=bool(regulated), pairing=pairing,
                 thresholded=bool(thresholded), threshold=float(threshold),
                 wireless=bool(wireless))
    if dev.type == "cpu":
        return slot_step_plain(state, problem, arrivals,
                               reg_draws if regulated else None, eps_b,
                               **flags)
    if dev.type != "cuda":
        raise ValueError(f"slot_step_fused: unsupported device {dev}")
    new = {k: torch.empty_like(state[k]) for k in STATE_LEAVES}
    f32 = dict(dtype=torch.float32, device=dev)
    metrics = {"total_queue": torch.empty((B,), **f32),
               "routed": torch.empty((B,), **f32),
               "computed": torch.empty((B,), **f32),
               "Z": torch.empty((B, NC), **f32),
               "n_star": torch.empty((B,), dtype=torch.int32, device=dev)}
    ptrs = {**inputs, **{"o_" + k: v for k, v in new.items()}, **metrics}
    args = _SlotStepArgs(
        **{k: ptrs[k].data_ptr() if k in ptrs else None
           for k in _STEP_POINTERS},
        B=B, N=N, NC=NC, E=E, load_balance=flags["load_balance"],
        fixed_node=flags["fixed_node"], regulated=flags["regulated"],
        pairing_bound=pairing == "bound", thresholded=flags["thresholded"],
        wireless=flags["wireless"], threshold=flags["threshold"])
    if B:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _step_lib().bp_slot_step(ctypes.byref(args), stream)
        if err == _TOO_LARGE:
            raise ValueError(
                f"slot_step_fused: a sim of shape N={N}, NC={NC}, E={E} does "
                f"not fit one block's shared memory")
        _raise_on(err, "slot_step_fused")
        if torch.cuda.is_current_stream_capturing():
            slot_step_fused.captured += 1
        else:
            slot_step_fused.launches += 1
    metrics.update(delivered=new["delivered"],
                   delivered_useful=new["delivered_useful"])
    return new, metrics


slot_step_fused.launches = 0
slot_step_fused.captured = 0
slot_step_fused.replayed = 0


def slot_step_smem_bytes(N: int, NC: int, E: int) -> int:
    """Dynamic shared memory one sim's block takes (builds the kernel)."""
    return int(_step_lib().bp_slot_step_smem_bytes(N, NC, E))
