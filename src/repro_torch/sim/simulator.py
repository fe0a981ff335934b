"""Slot-level trace simulator (the Fig. 5b/5c path).

Port of `repro.sim.simulator`.  `make_step(pp, cfg)` is the body of one
slot; `make_trace_runner(pp, cfg)` runs it over a [B, T] arrival trace
on the problem's device and keeps [B, T] traces.  `simulate` runs one problem for T slots
and keeps [T] traces; `sweep_rates` runs one problem at several query
rates as one batch (the reference's `vmap` over lambda) and keeps [L, T]
traces.  All run on CUDA unless the caller passes ``device="cpu"``.

The reference's runner is one jitted `lax.scan`.  Here, on CUDA, it is one
captured program too: the first `GRAPH_SLOTS` slots run eagerly, then
those slots are captured once into a `torch.cuda.CUDAGraph` over static
tensors (the problem, the state, a block of arrivals and of fed regulator
bits, the slot counter that keys the regulator's uniforms, and a
[5, B, block] trace block) and replayed block after block; after each
replay the trace block is copied into the [5, B, T] result on the device,
and slots beyond the last whole block run eagerly.  The graph is captured
once per (policy, batch, padded dims, noise kind, device)
(`make_trace_launch`, memoized as the fleet's `make_group_launch` is,
with the same capture and launch counts, `fleet.capture.CapturedSlots`),
so a second problem of the same shape, or a second run, replays it.  A slot
does the same operations on the same tensors whether it is replayed or
run eagerly, so the two agree bit for bit.  On the CPU the runner is the
eager loop of the plain slot step.

Noise comes from the port's counter-based stream keyed by ``seed``: every
rate of a sweep sees the same uniforms (common random numbers), each turned
into counts by its own Poisson table.  Fed arrivals and regulator bits
(``run(arrivals, reg_draws)``) replace the stream: the tests feed the
reference's.
"""
from __future__ import annotations

import functools
import numbers
from typing import Callable, NamedTuple

import torch

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.policies import PolicyConfig, slot_step
from repro_torch.core.queues import NetState, init_state
from repro_torch.device import resolve_device, tree_leaves
from repro_torch.fleet.batching import (LEAVES, PadDims, PaddedProblem,
                                        pad_problem)
from repro_torch.fleet.capture import (GRAPH_SLOTS, CapturedSlots,
                                       launch_device)
from repro_torch.obs import spans
from . import workload


class SimResult(NamedTuple):
    final_state: NetState         # batched [B, ...] (B = 1 for `simulate`)
    total_queue: torch.Tensor     # [..., T] backlog trajectory
    delivered: torch.Tensor       # [..., T] cumulative processed packets at d
    delivered_useful: torch.Tensor  # [..., T]
    computed: torch.Tensor        # [..., T] per-slot computations
    n_star: torch.Tensor          # [..., T] chosen comp node index

    @property
    def avg_queue(self) -> torch.Tensor:
        """Time-average total backlog (the paper's stability metric)."""
        return self.total_queue.mean(-1)

    def useful_rate(self, window: int | None = None) -> torch.Tensor:
        """Delivered-useful throughput over the trailing ``window`` slots
        (the baseline is the count at the last slot before the window)."""
        d = self.delivered_useful
        T = d.shape[-1]
        if window is None or window >= T:
            return d[..., -1] / T
        start = T - 1 - window
        return (d[..., -1] - d[..., start]) / window


def make_step(pp: PaddedProblem, cfg: PolicyConfig) -> Callable:
    """The body of one slot for every sim of ``pp`` (the reference's scan
    body): ``step(state, (arrivals [B], reg_draws [B, NC] or None))``
    returns ``(state, (total_queue, delivered, delivered_useful, computed,
    n_star))``, each [B] (n_star int32).  Regulated policies need the
    regulator's bits."""
    eps = torch.full((pp.batch,), cfg.eps_b, dtype=torch.float32,
                     device=pp.device)

    def step(state: NetState, inputs):
        arrivals, reg = inputs
        state, m = slot_step(pp, cfg, state, arrivals, reg, eps)
        return state, (m["total_queue"], m["delivered"],
                       m["delivered_useful"], m["computed"], m["n_star"])

    return step


def _padded(problem: ComputeProblem, device) -> PaddedProblem:
    """``problem`` as a batch of one on ``device`` (CUDA unless asked)."""
    return pad_problem(problem, PadDims.of([problem]), resolve_device(device))


def build_step(problem: ComputeProblem, cfg: PolicyConfig, device=None):
    """(the problem as a batch of one, its slot body), on ``device``."""
    pp = _padded(problem, device)
    return pp, make_step(pp, cfg)


def _advance(step, state: NetState, arrivals, draws, seed, t, eps, trace,
             n: int) -> NetState:
    """``n`` slots from ``state``.  Slot j reads ``arrivals[:, j]`` and the
    regulator's bits (``draws[:, j]``, or those of ``seed`` at slot ``t``,
    or none), writes its five metrics into ``trace[:, :, j]``; ``t``
    advances in place.  Returns the state after the last slot."""
    for j in range(n):
        if draws is not None:
            reg = draws[:, j]
        elif seed is not None:
            reg = workload.regulator_bits(seed, t, eps, state.H.shape[1])
        else:
            reg = None
        state, out = step(state, (arrivals[:, j], reg))
        t.add_(1)
        trace[:, :, j].copy_(torch.stack([*out[:4],
                                          out[4].to(torch.float32)]))
    return state


def _result(state: NetState, traces: torch.Tensor) -> SimResult:
    return SimResult(state, traces[0], traces[1], traces[2], traces[3],
                     traces[4].to(torch.int32))


class TraceLaunch(CapturedSlots):
    """The trace runner of one (policy, batch, padded dims, noise kind) on
    one CUDA device, on tensors allocated once: the problem, the state,
    the block inputs (``arr`` [B, block]; ``reg`` [B, block, NC] when the
    bits are fed), ``seed`` and the slot counter ``t`` [B] that key the
    regulator's uniforms, ``eps`` [B], and the trace block ``trace``
    [5, B, block].  ``noise`` is "none" (an unregulated policy), "seed"
    or "draws".  A run copies its problem in and resets the rest; nothing
    rebinds them, so the graph captured over them stays valid.  The
    capture and its counts are `CapturedSlots`'."""

    def __init__(self, cfg: PolicyConfig, batch: int, dims: PadDims,
                 noise: str, device: torch.device):
        super().__init__(GRAPH_SLOTS)
        self.cfg = cfg
        self.batch = batch
        self.dims = dims
        self.noise = noise
        self.device = device
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.long, device=device)
        self.arr = torch.zeros((batch, self.block), **f32)
        self.reg = (torch.zeros((batch, self.block, dims.n_comp), **f32)
                    if noise == "draws" else None)
        self.seed = torch.zeros((batch,), **i64)
        self.t = torch.zeros((batch,), **i64)
        self.eps = torch.full((batch,), cfg.eps_b, **f32)
        self.trace = torch.zeros((5, batch, self.block), **f32)
        self.pp = None
        self.state = None
        self.step = None

    def _load(self, pp: PaddedProblem, seed: int) -> None:
        if self.pp is None:
            self.pp = pp.replace(**{k: getattr(pp, k).clone()
                                    for k in LEAVES})
            self.state = init_state(self.pp)
            self.step = make_step(self.pp, self.cfg)
        else:
            for k in LEAVES:
                getattr(self.pp, k).copy_(getattr(pp, k))
            for leaf in tree_leaves(self.state):
                leaf.zero_()
        self.seed.fill_(seed)
        self.t.zero_()

    def _block(self, n: int) -> None:
        """``n`` slots of the static block, the state written back."""
        new = _advance(self.step, self.state, self.arr, self.reg,
                       self.seed if self.noise == "seed" else None, self.t,
                       self.eps, self.trace, n)
        for o, v in zip(tree_leaves(self.state), tree_leaves(new)):
            o.copy_(v)

    def run(self, pp: PaddedProblem, arrivals: torch.Tensor, seed: int,
            draws: torch.Tensor | None) -> SimResult:
        """The whole trace: ``arrivals`` [B, T], ``draws`` [B, T, NC] when
        the noise kind is "draws"."""
        with spans.span("trace.load"):
            self._load(pp, seed)
        T = arrivals.shape[1]
        traces = torch.empty((5, self.batch, T), dtype=torch.float32,
                             device=self.device)
        for s in range(0, T, self.block):
            with spans.span("trace.block", self.device):
                n = min(self.block, T - s)
                self.arr[:, :n].copy_(arrivals[:, s:s + n])
                if self.reg is not None:
                    self.reg[:, :n].copy_(draws[:, s:s + n])
                if n == self.block and self.graph is not None:
                    self.replay()
                else:
                    self._block(n)
                    if n == self.block:
                        self.capture(lambda: self._block(self.block))
                traces[:, :, s:s + n].copy_(self.trace[:, :, :n])
        with spans.span("trace.result"):
            state = NetState(*(v.clone() for v in tree_leaves(self.state)))
            return _result(state, traces)


@functools.lru_cache(maxsize=16)
def make_trace_launch(cfg: PolicyConfig, batch: int, dims: PadDims,
                      noise: str, device: torch.device) -> TraceLaunch:
    """The `TraceLaunch` of one shape, memoized: every later run of the
    same shape reuses its tensors and its captured graph."""
    return TraceLaunch(cfg, batch, dims, noise, device)


def _expand(pp: PaddedProblem, B: int) -> PaddedProblem:
    """``pp`` for B sims: itself, or its one problem repeated."""
    if pp.batch == B:
        return pp
    if pp.batch != 1:
        raise ValueError(f"a problem batch of {pp.batch} cannot run "
                         f"{B} arrival rows")
    return pp.replace(**{k: getattr(pp, k).expand(B, *getattr(
        pp, k).shape[1:]).contiguous() for k in LEAVES})


class TraceRunner:
    """``run(arrivals [B, T], seed | reg_draws [B, T, NC]) -> SimResult``
    with [B, T] traces (see `make_trace_runner`)."""

    def __init__(self, pp: PaddedProblem, cfg: PolicyConfig):
        self.pp = pp
        self.cfg = cfg
        self.device = launch_device(pp.device)
        self.launch = None

    def _inputs(self, arrivals, noise):
        arrivals = torch.as_tensor(arrivals).to(device=self.device,
                                                dtype=torch.float32)
        if arrivals.dim() != 2:
            raise ValueError(f"arrivals must be [B, T], got "
                             f"{tuple(arrivals.shape)}")
        B, T = arrivals.shape
        seed, draws = 0, None
        if isinstance(noise, numbers.Integral):
            seed = int(noise)
        else:
            draws = torch.as_tensor(noise).to(device=self.device,
                                               dtype=torch.float32)
            want = (B, T, self.pp.n_comp)
            if tuple(draws.shape) != want:
                raise ValueError(f"reg_draws must be {want}, got "
                                 f"{tuple(draws.shape)}")
        kind = ("none" if not self.cfg.use_regulator else
                "seed" if draws is None else "draws")
        return arrivals, seed, draws, kind

    def eager(self, arrivals, noise=0) -> SimResult:
        """The eager loop of the slot step (the CPU's runner; on CUDA the
        graph's counterpart, slot by slot)."""
        arrivals, seed, draws, kind = self._inputs(arrivals, noise)
        B, T = arrivals.shape
        pp = _expand(self.pp, B)
        traces = torch.empty((5, B, T), dtype=torch.float32,
                             device=self.device)
        t = torch.zeros((B,), dtype=torch.long, device=self.device)
        seeds = torch.full((B,), seed, dtype=torch.long, device=self.device)
        eps = torch.full((B,), self.cfg.eps_b, dtype=torch.float32,
                         device=self.device)
        state = _advance(make_step(pp, self.cfg), init_state(pp), arrivals,
                         draws if kind == "draws" else None,
                         seeds if kind == "seed" else None, t, eps, traces, T)
        return _result(state, traces)

    def __call__(self, arrivals, noise=0) -> SimResult:
        if self.device.type != "cuda":
            return self.eager(arrivals, noise)
        arrivals, seed, draws, kind = self._inputs(arrivals, noise)
        B = arrivals.shape[0]
        self.launch = make_trace_launch(
            self.cfg, B, PadDims(self.pp.n_nodes, self.pp.n_edges,
                                 self.pp.n_comp), kind, self.device)
        return self.launch.run(_expand(self.pp, B), arrivals, seed, draws)


def make_trace_runner(pp: PaddedProblem, cfg: PolicyConfig) -> TraceRunner:
    """The runner shared by `simulate` and `sweep_rates`:
    ``run(arrivals [B, T], seed | reg_draws [B, T, NC]) -> SimResult`` with
    [B, T] traces, every row on the problem of ``pp`` (a batch of one, or
    of B).  The int ``seed`` keys the regulator's bits; fed ``reg_draws``
    replace them.  It runs on the problem's device: on CUDA through one
    captured graph per shape, on the CPU as an eager loop."""
    return TraceRunner(pp, cfg)


def simulate(problem: ComputeProblem, cfg: PolicyConfig, lam: float, T: int,
             seed: int = 0, arrivals: torch.Tensor | None = None,
             reg_draws: torch.Tensor | None = None,
             device=None) -> SimResult:
    """Run T slots with Poisson(lam) arrivals (or a supplied [T] trace and,
    for regulated policies, optional [T, NC] regulator draws); traces are
    [T]."""
    pp = _padded(problem, device)
    if arrivals is None:
        arrivals = workload.poisson_arrivals([lam], T, seed, pp.device)[0]
    arrivals = torch.as_tensor(arrivals)
    if arrivals.shape[0] != T:
        raise ValueError(
            f"arrivals trace has {arrivals.shape[0]} slots but T={T}")
    run = make_trace_runner(pp, cfg)
    res = run(arrivals[None], seed if reg_draws is None else
              torch.as_tensor(reg_draws)[None])
    return SimResult(res.final_state, *(x[0] for x in res[1:]))


@spans.traced("trace.sweep")
def sweep_rates(problem: ComputeProblem, cfg: PolicyConfig, lams, T: int,
                seed: int = 0, device=None) -> SimResult:
    """The full simulation at every rate of ``lams`` as one batch
    (Fig. 5b); traces are [L, T]."""
    with spans.span("trace.arrivals"):
        pp = _padded(problem, device)
        lams = [float(x) for x in lams]
        arrivals = workload.poisson_arrivals(lams, T, seed, pp.device)
    return make_trace_runner(pp, cfg)(arrivals, seed)
