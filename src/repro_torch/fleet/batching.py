"""Padded topology batching: heterogeneous graphs as one batch of tensors.

Port of `repro.fleet.batching`.  Every instance is padded to shared maxima
``(n_nodes, n_edges, n_comp)`` and the fleet is one `PaddedProblem` whose
tensor leaves carry a leading batch axis [B]:

  * padded edges are self-loops ``(0, 0)`` with ``edge_cap == 0`` and
    ``edge_mask == 0`` (zero differential backlog: they never route);
  * padded computation nodes point at node 0 with ``comp_caps == 0`` and
    ``comp_mask == 0`` (never win the load-balance argmin, combine nothing);
  * ``sink`` rows of padded classes are all False.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.queues import StaticProblem
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.bp_slot.ref import PROBLEM_LEAVES as LEAVES


@dataclasses.dataclass(frozen=True)
class PaddedProblem:
    """A batch of padded problems; every tensor leaf has a leading [B]."""

    n_nodes: int                 # padded node count
    n_comp: int                  # padded comp-node count
    edges: torch.Tensor          # [B, E, 2] int32
    edge_cap: torch.Tensor       # [B, E] float32
    s1: torch.Tensor             # [B] int32
    s2: torch.Tensor             # [B] int32
    dest: torch.Tensor           # [B] int32
    comp_nodes: torch.Tensor     # [B, NC] int32
    comp_caps: torch.Tensor      # [B, NC] float32
    sink: torch.Tensor           # [B, N, 3, NC] bool
    edge_mask: torch.Tensor      # [B, E] float32
    comp_mask: torch.Tensor      # [B, NC] float32

    @property
    def batch(self) -> int:
        return int(self.edges.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[-2])

    @property
    def device(self) -> torch.device:
        return self.edges.device

    def replace(self, **kw) -> "PaddedProblem":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PaddedProblem":
        return self.replace(**{k: getattr(self, k).to(device)
                               for k in LEAVES})

    def with_capacity_scales(self, edge_scale: torch.Tensor,
                             comp_scale: torch.Tensor) -> "PaddedProblem":
        """Per-slot time-varying capacities (event models).  A comp node
        whose scale is zero this slot is also gated out of ``comp_mask``."""
        return self.replace(
            edge_cap=self.edge_cap * edge_scale,
            comp_caps=self.comp_caps * comp_scale,
            comp_mask=self.comp_mask * (comp_scale > 0.0).to(torch.float32))


def problem_shape(problem: ComputeProblem) -> Tuple[int, int, int]:
    """The (n_nodes, n_edges, n_comp) shape of one instance."""
    return (int(problem.graph.n_nodes), int(problem.graph.n_edges),
            int(problem.n_comp))


@dataclasses.dataclass(frozen=True)
class PadDims:
    n_nodes: int
    n_edges: int
    n_comp: int

    @staticmethod
    def of(problems: Sequence[ComputeProblem]) -> "PadDims":
        problems = list(problems)
        if not problems:
            raise ValueError(
                "PadDims.of: empty problem sequence — there is nothing to "
                "take shape maxima over")
        return PadDims(
            n_nodes=max(p.graph.n_nodes for p in problems),
            n_edges=max(p.graph.n_edges for p in problems),
            n_comp=max(p.n_comp for p in problems),
        )

    def fits(self, problem: ComputeProblem) -> bool:
        n, e, nc = problem_shape(problem)
        return n <= self.n_nodes and e <= self.n_edges and nc <= self.n_comp


def make_buckets(problems: Sequence[ComputeProblem],
                 n_buckets: int = 1
                 ) -> Tuple[List[PadDims], List[int]]:
    """Partition problems into size buckets with per-bucket `PadDims`
    (quantiles of the lexicographic (n_edges, n_nodes, n_comp) key; the
    same rule as `repro.fleet.batching.make_buckets`)."""
    problems = list(problems)
    if not problems:
        raise ValueError("make_buckets: empty problem sequence")
    n_buckets = max(1, int(n_buckets))
    shapes = np.array([problem_shape(p) for p in problems], np.int64)
    key = (shapes[:, 1] << 40) | (shapes[:, 0] << 20) | shapes[:, 2]
    cuts = [int(np.quantile(key, (b + 1) / n_buckets, method="lower"))
            for b in range(n_buckets - 1)]
    raw = np.zeros(len(problems), np.int64)
    for c in cuts:
        raw += key > c
    dense: Dict[int, int] = {}
    for r in sorted(set(raw.tolist())):
        dense[r] = len(dense)
    assignment = [dense[int(r)] for r in raw]
    bucket_dims = []
    for b in range(len(dense)):
        members = [p for p, a in zip(problems, assignment) if a == b]
        bucket_dims.append(PadDims.of(members))
    validate_buckets(problems, bucket_dims, assignment)
    return bucket_dims, assignment


def validate_buckets(problems: Sequence[ComputeProblem],
                     bucket_dims: Sequence[PadDims],
                     assignment: Sequence[int]) -> None:
    """Raise ValueError unless every problem fits its bucket's dims."""
    if len(problems) != len(assignment):
        raise ValueError(
            f"validate_buckets: {len(problems)} problems but "
            f"{len(assignment)} bucket assignments")
    for i, (p, b) in enumerate(zip(problems, assignment)):
        if not 0 <= b < len(bucket_dims):
            raise ValueError(
                f"validate_buckets: problem {i} assigned to bucket {b}, "
                f"but only {len(bucket_dims)} buckets exist")
        d = bucket_dims[b]
        if not d.fits(p):
            n, e, nc = problem_shape(p)
            raise ValueError(
                f"validate_buckets: problem {i} with shape (n_nodes={n}, "
                f"n_edges={e}, n_comp={nc}) exceeds bucket {b} dims "
                f"(n_nodes={d.n_nodes}, n_edges={d.n_edges}, "
                f"n_comp={d.n_comp})")


def pad_leaves(problem: ComputeProblem, dims: PadDims) -> Dict[str, np.ndarray]:
    """One problem embedded into the padded shapes, as numpy leaves."""
    sp = StaticProblem.build(problem)
    N, E, NC = dims.n_nodes, dims.n_edges, dims.n_comp
    e, nc = sp.edges.shape[0], sp.n_comp
    if sp.n_nodes > N or e > E or nc > NC:
        raise ValueError(
            f"pad_problem: instance shape (n_nodes={sp.n_nodes}, "
            f"n_edges={e}, n_comp={nc}) exceeds pad dims (n_nodes={N}, "
            f"n_edges={E}, n_comp={NC})")
    edges = np.zeros((E, 2), np.int32)               # padding: self-loop (0,0)
    edges[:e] = sp.edges
    edge_cap = np.zeros((E,), np.float32)
    edge_cap[:e] = sp.edge_cap
    edge_mask = np.zeros((E,), np.float32)
    edge_mask[:e] = 1.0
    comp_nodes = np.zeros((NC,), np.int32)           # padding: node 0, cap 0
    comp_nodes[:nc] = sp.comp_nodes
    comp_caps = np.zeros((NC,), np.float32)
    comp_caps[:nc] = sp.comp_caps
    comp_mask = np.zeros((NC,), np.float32)
    comp_mask[:nc] = 1.0
    sink = np.zeros((N, 3, NC), bool)
    sink[:sp.n_nodes, :, :nc] = sp.sink
    return dict(edges=edges, edge_cap=edge_cap, s1=np.int32(sp.s1),
                s2=np.int32(sp.s2), dest=np.int32(sp.dest),
                comp_nodes=comp_nodes, comp_caps=comp_caps, sink=sink,
                edge_mask=edge_mask, comp_mask=comp_mask)


def from_leaves(leaves: Sequence[Dict[str, np.ndarray]], n_nodes: int,
                n_comp: int, device=None) -> PaddedProblem:
    """Stack per-problem numpy leaves into one batched PaddedProblem on
    ``device``: CUDA unless the caller asks (`resolve_device`), raising
    without a card."""
    dev = resolve_device(device)
    return PaddedProblem(n_nodes=n_nodes, n_comp=n_comp, **{
        k: upload(np.stack([np.asarray(lv[k]) for lv in leaves]), dev)
        for k in LEAVES})


def pad_problem(problem: ComputeProblem, dims: PadDims,
                device=None) -> PaddedProblem:
    """One problem as a batch of one (B = 1)."""
    return from_leaves([pad_leaves(problem, dims)], dims.n_nodes,
                       dims.n_comp, device)


def stack_problems(problems: Sequence[ComputeProblem],
                   dims: PadDims | None = None, device=None) -> PaddedProblem:
    """Pad and stack a fleet of problems into one batched PaddedProblem."""
    dims = dims or PadDims.of(problems)
    return from_leaves([pad_leaves(p, dims) for p in problems], dims.n_nodes,
                       dims.n_comp, device)
