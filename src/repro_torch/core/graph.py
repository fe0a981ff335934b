"""Network graph abstraction for in-network computation.

The port's own copy of `repro.core.graph` (numpy only): importing the JAX
package's module would run `repro/core/__init__.py`, which imports jax.

The paper models a capacitated undirected graph G=(V,E) with two data sources
s1, s2, one destination d, and a set of computation nodes N_C with per-node
computation capacities C_n (results/slot).  Edges carry R_ml packets/slot,
shared by both directions and all packet classes (paper eq. (1)).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static undirected network graph."""

    n_nodes: int
    edges: np.ndarray        # [E, 2] int, undirected node pairs (m, l)
    capacity: np.ndarray     # [E] float, R_ml packets/slot (shared by directions)

    def __post_init__(self):
        object.__setattr__(self, "edges", np.asarray(self.edges, dtype=np.int32))
        object.__setattr__(self, "capacity", np.asarray(self.capacity, dtype=np.float64))
        assert self.edges.ndim == 2 and self.edges.shape[1] == 2
        assert self.capacity.shape == (self.edges.shape[0],)
        assert (self.edges >= 0).all() and (self.edges < self.n_nodes).all()
        assert (self.edges[:, 0] != self.edges[:, 1]).all(), "no self loops"

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def directed_edges(self) -> np.ndarray:
        """[2E, 2] — both orientations of every undirected edge."""
        fwd = self.edges
        bwd = self.edges[:, ::-1]
        return np.concatenate([fwd, bwd], axis=0)

    def neighbors(self, node: int) -> list[int]:
        out = []
        for m, l in self.edges:
            if m == node:
                out.append(int(l))
            elif l == node:
                out.append(int(m))
        return sorted(set(out))


def grid_graph(rows: int, cols: int, capacity: float) -> Graph:
    """rows x cols grid; node id = r*cols + c. All edges share `capacity`."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            if c + 1 < cols:
                edges.append((u, u + 1))
            if r + 1 < rows:
                edges.append((u, u + cols))
    edges = np.array(edges, dtype=np.int32)
    return Graph(rows * cols, edges, np.full(len(edges), capacity))


def line_graph(n: int, capacity: float) -> Graph:
    edges = np.array([(i, i + 1) for i in range(n - 1)], dtype=np.int32)
    return Graph(n, edges, np.full(len(edges), capacity))


def triangle_graph(capacity: float | Sequence[float] = 1.0) -> Graph:
    """The motivating example of the paper: nodes {0,1,2} fully connected."""
    edges = np.array([(0, 1), (0, 2), (1, 2)], dtype=np.int32)
    cap = np.full(3, capacity) if np.isscalar(capacity) else np.asarray(capacity)
    return Graph(3, edges, cap)


@dataclasses.dataclass(frozen=True)
class ComputeProblem:
    """A query-stream computation problem instance (paper §II)."""

    graph: Graph
    s1: int
    s2: int
    dest: int
    comp_nodes: tuple[int, ...]          # N_C
    comp_caps: tuple[float, ...]         # C_n, results/slot

    def __post_init__(self):
        object.__setattr__(self, "comp_nodes", tuple(int(n) for n in self.comp_nodes))
        object.__setattr__(self, "comp_caps", tuple(float(c) for c in self.comp_caps))
        assert len(self.comp_nodes) == len(self.comp_caps)
        for n in (self.s1, self.s2, self.dest, *self.comp_nodes):
            assert 0 <= n < self.graph.n_nodes

    @property
    def n_comp(self) -> int:
        return len(self.comp_nodes)


def paper_grid_problem(C: float = 2.0, R: float = 5.0) -> ComputeProblem:
    """The 4x4 grid instance of paper §V (Fig. 5a).

    The figure raster is unavailable in the text dump; placement below is
    calibrated so the Theorem-4 LP reproduces the paper's reported capacities
    (lambda* = 8 for C=2, ~9.8 for C=3).  See DESIGN.md §1.
    """
    g = grid_graph(4, 4, R)
    return ComputeProblem(
        graph=g, s1=0, s2=3, dest=15,
        comp_nodes=(5, 6, 9, 10), comp_caps=(C,) * 4,
    )
