"""Scenario registry: topology generators + event/arrival models, batched.

Port of `repro.fleet.scenarios`.  A `Scenario` bundles a topology factory
(topo_seed -> ComputeProblem), an arrival-process model, a capacity event
model and the interference model (wired vs wireless).  The numpy topology
generators are copied verbatim, so each ``topo_seed`` rebuilds the very
problem the JAX package builds.

Arrival and event models are online functions over the fleet batch [B].
They take their randomness as uniforms (drawn by the engine from the
port's counter-based stream, `repro_torch.sim.workload`, or fed by a
test), and a `ModState` that carries the Markov chains.  The registries
keep the JAX package's frozen code order, so per-job integer codes mean
the same model in both packages.  Where a group mixes models, the engine
evaluates every model present and selects per sim with `torch.where`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (ComputeProblem, Graph, grid_graph,
                                    paper_grid_problem)
from repro_torch.sim import workload


@dataclasses.dataclass(frozen=True)
class ModState:
    """Markov-modulation state of every sim of a batch.

      link[b, e] : 1.0 = Good / 0.0 = Bad   (Gilbert–Elliott channel state)
      comp[b, n] : 1.0 = Up   / 0.0 = Down  (Gilbert–Elliott comp-node state)
      burst[b]   : 1.0 = ON  / 0.0 = OFF    (Markov-modulated arrival phase)
    """

    link: torch.Tensor    # [B, E] float32
    comp: torch.Tensor    # [B, NC] float32
    burst: torch.Tensor   # [B] float32

    @staticmethod
    def init(pp) -> "ModState":
        """All links Good, all comp nodes Up, arrivals ON."""
        B, E, dev = pp.batch, pp.n_edges, pp.device
        one = dict(dtype=torch.float32, device=dev)
        return ModState(torch.ones((B, E), **one),
                        torch.ones((B, pp.n_comp), **one),
                        torch.ones((B,), **one))

    def replace(self, **kw) -> "ModState":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Arrival models: (lam [B], u [B] f64, u_phase [B] f32, cdf [B, K], mod)
# -> (arrivals [B] f32, mod').  ``u`` drives the count, ``u_phase`` the
# ON-OFF flip; ``cdf`` is each sim's Poisson table (`arrival_rates`).
# ---------------------------------------------------------------------------

def _arrival_poisson(lam, u, u_phase, cdf, mod):
    return workload.poisson_from_uniform(u, cdf), mod


def _arrival_bernoulli_batch(lam, u, u_phase, cdf, mod):
    return workload.bernoulli_from_uniform(u, lam), mod


def _arrival_constant(lam, u, u_phase, cdf, mod):
    return lam.to(torch.float32), mod


# Markov ON-OFF (interrupted-Poisson) defaults: stationary P(ON) = 0.75,
# mean ON run 1/P_OFF = 20 slots, mean OFF run 1/P_ON ≈ 6.7 slots.
MMPP_P_ON_OFF = 0.05     # P(ON -> OFF) per slot
MMPP_P_OFF_ON = 0.15     # P(OFF -> ON) per slot
MMPP_PI_ON = MMPP_P_OFF_ON / (MMPP_P_ON_OFF + MMPP_P_OFF_ON)


def _arrival_markov_onoff(lam, u, u_phase, cdf, mod):
    """Markov-modulated ON-OFF Poisson arrivals: while ON, Poisson(lam /
    P(ON)) (the table is built at that rate); while OFF, none."""
    on = torch.where(mod.burst > 0.5,
                     (u_phase >= MMPP_P_ON_OFF).to(torch.float32),
                     (u_phase < MMPP_P_OFF_ON).to(torch.float32))
    arr = workload.poisson_from_uniform(u, cdf) * on
    return arr, mod.replace(burst=on)


ARRIVAL_MODELS: Dict[str, Callable] = {
    "poisson": _arrival_poisson,
    "bernoulli_batch": _arrival_bernoulli_batch,
    "constant": _arrival_constant,
    "markov_onoff": _arrival_markov_onoff,
}
ARRIVAL_MODEL_ORDER: Tuple[str, ...] = tuple(ARRIVAL_MODELS)


def arrival_code(name: str) -> int:
    return ARRIVAL_MODEL_ORDER.index(name)


def arrival_rates(lam: np.ndarray, akind: np.ndarray) -> np.ndarray:
    """Each sim's Poisson table rate: lam, or lam / P(ON) for ON-OFF."""
    lam = np.asarray(lam, np.float64)
    onoff = np.asarray(akind) == arrival_code("markov_onoff")
    return np.where(onoff, lam / MMPP_PI_ON, lam)


# ---------------------------------------------------------------------------
# Event models: (pp, t [B], u_link [B, E], u_comp [B, NC], mod)
# -> (edge_scale [B, E], comp_scale [B, NC], mod').
# ---------------------------------------------------------------------------

def _ones(pp, t):
    one = dict(dtype=torch.float32, device=t.device)
    return (torch.ones((t.shape[0], pp.n_edges), **one),
            torch.ones((t.shape[0], pp.n_comp), **one))


def _ev_static(pp, t, u_link, u_comp, mod):
    es, cs = _ones(pp, t)
    return es, cs, mod


def _ev_fading(pp, t, u_link, u_comp, mod, period: float = 200.0,
               depth: float = 0.35):
    """Deterministic per-link slow fading with an edge-dependent phase."""
    E = pp.n_edges
    phase = torch.arange(E, dtype=torch.float32, device=t.device) / \
        float(max(E, 1))
    s = 1.0 - depth + depth * torch.cos(
        2.0 * math.pi * (t.to(torch.float32)[:, None] / period + phase))
    return s.to(torch.float32), _ones(pp, t)[1], mod


def _ev_link_flaps(pp, t, u_link, u_comp, mod, p_up: float = 0.9):
    """i.i.d. per-slot link outages: each edge is up w.p. `p_up`."""
    return (u_link < p_up).to(torch.float32), _ones(pp, t)[1], mod


def _ev_comp_failures(pp, t, u_link, u_comp, mod, p_up: float = 0.9):
    """i.i.d. per-slot comp-node failure/recovery (queues kept)."""
    return _ones(pp, t)[0], (u_comp < p_up).to(torch.float32), mod


# Gilbert–Elliott defaults: stationary P(Bad) = P_GB/(P_GB+P_BG) ≈ 0.091,
# mean Bad run 1/P_BG = 5 slots, long-run mean capacity scale ≈ 0.93.
GE_P_GB = 0.02           # P(Good -> Bad) per slot, per link
GE_P_BG = 0.20           # P(Bad -> Good) per slot, per link
GE_BAD_SCALE = 0.25      # capacity multiplier while Bad

# Comp-node Gilbert–Elliott defaults: stationary P(Down) = 0.0625, mean
# outage 1/P_DU ≈ 6.7 slots.
GE_COMP_P_UD = 0.01      # P(Up -> Down) per slot, per comp node
GE_COMP_P_DU = 0.15      # P(Down -> Up) per slot, per comp node


def _ge_step(u, good, p_enter_bad: float, p_exit_bad: float):
    """One transition of independent 2-state Good/Bad chains."""
    return torch.where(good > 0.5,
                       (u >= p_enter_bad).to(torch.float32),
                       (u < p_exit_bad).to(torch.float32))


def _ev_gilbert_elliott(pp, t, u_link, u_comp, mod):
    """2-state Markov (Gilbert–Elliott) per-link fading."""
    good = _ge_step(u_link, mod.link, GE_P_GB, GE_P_BG)
    scale = GE_BAD_SCALE + (1.0 - GE_BAD_SCALE) * good
    return scale, _ones(pp, t)[1], mod.replace(link=good)


def _ev_ge_comp(pp, t, u_link, u_comp, mod):
    """Markov (Gilbert–Elliott) comp-node failures (outages persist)."""
    up = _ge_step(u_comp, mod.comp, GE_COMP_P_UD, GE_COMP_P_DU)
    return _ones(pp, t)[0], up, mod.replace(comp=up)


def _ev_ge_full(pp, t, u_link, u_comp, mod):
    """Gilbert–Elliott link fading and comp-node failures together."""
    link_scale, _, mod = _ev_gilbert_elliott(pp, t, u_link, u_comp, mod)
    _, comp_up, mod = _ev_ge_comp(pp, t, u_link, u_comp, mod)
    return link_scale, comp_up, mod


# Scripted comp-node outage: node `OUTAGE_NODE` is Down for slots
# [OUTAGE_LO, OUTAGE_HI).
OUTAGE_NODE = 0
OUTAGE_LO = 1024
OUTAGE_HI = 1536


def _ev_outage_window(pp, t, u_link, u_comp, mod):
    es, cs = _ones(pp, t)
    down = (t >= OUTAGE_LO) & (t < OUTAGE_HI)
    cs[:, OUTAGE_NODE] = torch.where(down, 0.0, 1.0)
    return es, cs, mod


EVENT_MODELS: Dict[str, Callable] = {
    "static": _ev_static,
    "fading": _ev_fading,
    "link_flaps": _ev_link_flaps,
    "comp_failures": _ev_comp_failures,
    "gilbert_elliott": _ev_gilbert_elliott,
    "ge_comp": _ev_ge_comp,
    "ge_full": _ev_ge_full,
    "outage_window": _ev_outage_window,   # appended: codes are frozen
}
EVENT_MODEL_ORDER: Tuple[str, ...] = tuple(EVENT_MODELS)

#: Event models that read the link / comp uniforms.
LINK_NOISE_EVENTS = ("link_flaps", "gilbert_elliott", "ge_full")
COMP_NOISE_EVENTS = ("comp_failures", "ge_comp", "ge_full")


def event_code(name: str) -> int:
    return EVENT_MODEL_ORDER.index(name)


# ---------------------------------------------------------------------------
# Topology generators.  All are (seed, **params) -> ComputeProblem with
# sources/dest/comp-node placement chosen by simple degree/eccentricity
# heuristics so every instance is feasible (connected, lam* > 0).
# ---------------------------------------------------------------------------

def _place(graph: Graph, n_comp: int, C: float,
           rng: np.random.Generator) -> ComputeProblem:
    """Pick s1/s2 far apart, dest far from both, comp nodes by degree."""
    n = graph.n_nodes
    deg = np.zeros(n, np.int64)
    for m, l in graph.edges:
        deg[m] += 1
        deg[l] += 1
    # BFS eccentricity from a random start to find a far pair.
    adj = [[] for _ in range(n)]
    for m, l in graph.edges:
        adj[m].append(int(l))
        adj[l].append(int(m))

    def bfs(src):
        dist = np.full(n, -1)
        dist[src] = 0
        q = [src]
        while q:
            u = q.pop(0)
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return dist

    s1 = int(rng.integers(n))
    d1 = bfs(s1)
    s2 = int(np.argmax(d1))
    d2 = bfs(s2)
    dest = int(np.argmax(d1 + d2))
    if dest in (s1, s2):
        dest = int(np.argsort(-(d1 + d2))[1])
    # highest-degree nodes (excluding endpoints) host computation
    order = np.argsort(-deg)
    comp = [int(u) for u in order if u not in (s1, s2, dest)][:n_comp]
    if len(comp) < n_comp:                       # tiny graphs: allow overlap
        comp += [int(u) for u in order if int(u) not in comp][:n_comp - len(comp)]
    return ComputeProblem(graph, s1, s2, dest,
                          tuple(comp), (C,) * len(comp))


def random_geometric(seed: int, n: int = 14, radius: float = 0.42,
                     cap: float = 4.0, n_comp: int = 3,
                     C: float = 2.0) -> ComputeProblem:
    """Random geometric graph in the unit square; a chain over x-sorted nodes
    is added so the graph is always connected."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    order = np.argsort(pts[:, 0])
    edges = set()
    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(pts[i] - pts[j]) <= radius:
                edges.add((min(i, j), max(i, j)))
    for a, b in zip(order[:-1], order[1:]):      # connectivity backbone
        edges.add((min(int(a), int(b)), max(int(a), int(b))))
    e = np.array(sorted(edges), np.int32)
    g = Graph(n, e, np.full(len(e), cap))
    return _place(g, n_comp, C, rng)


def ring(seed: int, n: int = 12, cap: float = 4.0, n_comp: int = 3,
         C: float = 2.0) -> ComputeProblem:
    e = np.array([(i, (i + 1) % n) for i in range(n)], np.int32)
    g = Graph(n, e, np.full(n, cap))
    return _place(g, n_comp, C, np.random.default_rng(seed))


def balanced_tree(seed: int, branch: int = 2, depth: int = 3, cap: float = 4.0,
                  n_comp: int = 3, C: float = 2.0) -> ComputeProblem:
    """Complete `branch`-ary tree of the given depth."""
    edges, nodes = [], 1
    frontier = [0]
    for _ in range(depth):
        nxt = []
        for u in frontier:
            for _ in range(branch):
                edges.append((u, nodes))
                nxt.append(nodes)
                nodes += 1
        frontier = nxt
    e = np.array(edges, np.int32)
    g = Graph(nodes, e, np.full(len(e), cap))
    return _place(g, n_comp, C, np.random.default_rng(seed))


def expander(seed: int, n: int = 14, cap: float = 4.0, n_comp: int = 3,
             C: float = 2.0) -> ComputeProblem:
    """Circulant expander: ring + chord offsets (2, n//2 - 1) + random chords."""
    rng = np.random.default_rng(seed)
    edges = set()
    for off in (1, 2, max(n // 2 - 1, 3)):
        for i in range(n):
            j = (i + off) % n
            if i != j:
                edges.add((min(i, j), max(i, j)))
    for _ in range(n // 3):                      # extra random chords
        i, j = rng.integers(n), rng.integers(n)
        if i != j:
            edges.add((min(int(i), int(j)), max(int(i), int(j))))
    e = np.array(sorted(edges), np.int32)
    g = Graph(n, e, np.full(len(e), cap))
    return _place(g, n_comp, C, rng)


def fat_tree(seed: int, pods: int = 2, hosts_per_edge: int = 2,
             core_cap: float = 8.0, agg_cap: float = 4.0,
             host_cap: float = 4.0, C: float = 2.0) -> ComputeProblem:
    """Miniature datacenter fat-tree: core -> per-pod agg -> edge -> hosts.
    Computation lives in the aggregation layer (in-network processing)."""
    edges, caps = [], []
    core, n = 0, 1                # node 0 is the single core of the mini tree
    aggs, hosts = [], []
    for _ in range(pods):
        agg, n = n, n + 1
        aggs.append(agg)
        edges.append((core, agg))
        caps.append(core_cap)
        for _ in range(2):
            sw, n = n, n + 1
            edges.append((agg, sw))
            caps.append(agg_cap)
            for _ in range(hosts_per_edge):
                h, n = n, n + 1
                hosts.append(h)
                edges.append((sw, h))
                caps.append(host_cap)
    g = Graph(n, np.array(edges, np.int32), np.array(caps))
    s1, s2 = int(hosts[0]), int(hosts[-1])       # opposite pods
    dest = int(hosts[len(hosts) // 2])
    if dest in (s1, s2):
        dest = int(hosts[1])
    return ComputeProblem(g, s1, s2, dest, tuple(aggs), (C,) * len(aggs))


def wireless_grid(seed: int, rows: int = 4, cols: int = 4, cap: float = 5.0,
                  C: float = 2.0) -> ComputeProblem:
    """The paper-§IV-C setting: grid graph under node-exclusive interference
    (pair with `wireless=True` in the scenario)."""
    g = grid_graph(rows, cols, cap)
    rng = np.random.default_rng(seed)
    return _place(g, n_comp=4, C=C, rng=rng)


# ---------------------------------------------------------------------------
# Scenario registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    factory: Callable[[int], ComputeProblem]     # topo seed -> problem
    arrival: str = "poisson"                     # ARRIVAL_MODELS key
    events: str = "static"                       # EVENT_MODELS key
    wireless: bool = False
    description: str = ""

    def build(self, topo_seed: int = 0) -> ComputeProblem:
        return self.factory(topo_seed)


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(s: Scenario) -> Scenario:
    if s.name in SCENARIOS:
        raise ValueError(f"scenario {s.name!r} already registered")
    if s.arrival not in ARRIVAL_MODELS:
        raise ValueError(f"unknown arrival model {s.arrival!r}")
    if s.events not in EVENT_MODELS:
        raise ValueError(f"unknown event model {s.events!r}")
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}") from None


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


register_scenario(Scenario(
    "paper_grid", lambda seed: paper_grid_problem(),
    description="The paper's 4x4 grid (Fig. 5a), C=2, R=5."))
register_scenario(Scenario(
    "random_geometric", random_geometric,
    description="Random geometric graph, degree-placed comp nodes."))
register_scenario(Scenario(
    "ring", ring, description="Cycle topology; worst-case path diversity."))
register_scenario(Scenario(
    "tree", balanced_tree,
    description="Complete binary tree; single-path routing stress."))
register_scenario(Scenario(
    "expander", expander,
    description="Circulant expander + random chords; high conductance."))
register_scenario(Scenario(
    "fat_tree", fat_tree, arrival="bernoulli_batch",
    description="Mini datacenter fat-tree; bursty arrivals, agg-layer compute."))
register_scenario(Scenario(
    "wireless_grid", wireless_grid, wireless=True,
    description="Grid under node-exclusive interference (greedy matching)."))
register_scenario(Scenario(
    "fading_geometric", random_geometric, events="fading",
    description="Random geometric graph with sinusoidal link fading."))
register_scenario(Scenario(
    "flaky_expander", expander, events="link_flaps",
    description="Expander with i.i.d. per-slot link outages."))
register_scenario(Scenario(
    "failing_grid", lambda seed: paper_grid_problem(), events="comp_failures",
    description="Paper grid with comp-node failure/recovery."))
register_scenario(Scenario(
    "ge_grid", lambda seed: paper_grid_problem(), events="gilbert_elliott",
    description="Paper grid under Gilbert–Elliott (Markov) link fading."))
register_scenario(Scenario(
    "ge_geometric", random_geometric, events="gilbert_elliott",
    description="Random geometric graph under Gilbert–Elliott link fading."))
register_scenario(Scenario(
    "bursty_grid", lambda seed: paper_grid_problem(), arrival="markov_onoff",
    description="Paper grid with Markov ON-OFF (correlated bursty) arrivals."))
register_scenario(Scenario(
    "ge_comp_grid", lambda seed: paper_grid_problem(), events="ge_comp",
    description="Paper grid with Markov (Gilbert–Elliott) comp-node "
                "failures: outages persist for ~1/P_DU slots."))
register_scenario(Scenario(
    "ge_full_grid", lambda seed: paper_grid_problem(), events="ge_full",
    description="Paper grid under combined Markov link fading AND "
                "comp-node failures."))
register_scenario(Scenario(
    "outage_grid", lambda seed: paper_grid_problem(), events="outage_window",
    description="Paper grid with a scripted comp-node outage in slots "
                "[OUTAGE_LO, OUTAGE_HI) — deterministic fault-injection "
                "for the serving shed/recover test."))
