"""Freeze the benchmark's deployments as data (run once, when a cell is
defined; the harness never runs it).

    PYTHONPATH=src python portbench/export.py

Writes `portbench/configs/atlas_hull.json` and
`portbench/configs/paper_grid.json`: every topology the cells run (nodes,
links and their capacities, sources, destination, computation nodes and
their capacities, arrival, event and interference model) and, for the
atlas, each topology's exact regulated LP bound, the grid indices of its
bisection's first probes and its shape bucket with the buckets' pad dims,
from `repro_torch`'s scenario factories, LP, search bracket and bucketing
rule.  The harness and the reference read only these files, so
a later change to a factory or to the LP cannot move the yardstick, and no
run solves an LP.
"""
from __future__ import annotations

import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: The repo's capacity atlas (`ATLAS_SWEEP` of the atlas benchmark): its
#: 9 families x topo seeds 0-55, policy, eps_B, horizon, chunk, probe grid
#: (rel_tol of each cell's exact bound, first bracket) and shape buckets.
HULL_FAMILIES = ("paper_grid", "random_geometric", "ring", "tree",
                 "expander", "fat_tree", "wireless_grid", "ge_grid",
                 "ge_comp_grid")
HULL_TOPO_SEEDS = tuple(range(56))
HULL_POLICY, HULL_EPS_B = "pi3", 0.05
HULL_REL_TOL, HULL_BRACKET, HULL_BUCKETS = 0.1, (0.5, 1.1), 3

#: The paper's Fig. 5(b) rate grids (paper Sec. V), as data.
PAPER_RATES = {
    "C2": [4.0, 5.0, 6.0, 6.5, 7.0, 7.5, 8.0, 8.5, 9.0],
    "C3": [5.0, 6.0, 7.0, 8.0, 8.5, 9.0, 9.5, 10.0, 10.5],
}


def topology(problem, arrival: str, events: str, wireless: bool) -> dict:
    """One `ComputeProblem` and its scenario's models as plain data."""
    g = problem.graph
    return {
        "n_nodes": int(g.n_nodes),
        "edges": [[int(m), int(l)] for m, l in g.edges],
        "capacity": [float(c) for c in g.capacity],
        "s1": int(problem.s1), "s2": int(problem.s2),
        "dest": int(problem.dest),
        "comp_nodes": [int(n) for n in problem.comp_nodes],
        "comp_caps": [float(c) for c in problem.comp_caps],
        "arrival": arrival, "events": events, "wireless": bool(wireless),
    }


def hull_topologies() -> dict:
    """{"<family>/<topo_seed>": topology} from the live scenario registry."""
    from repro_torch.fleet import get_scenario
    out = {}
    for fam in HULL_FAMILIES:
        sc = get_scenario(fam)
        for ts in HULL_TOPO_SEEDS:
            out[f"{fam}/{ts}"] = topology(sc.build(ts), sc.arrival,
                                          sc.events, sc.wireless)
    return out


def hull_bounds() -> dict:
    """{"<family>/<topo_seed>": exact regulated LP bound}."""
    from repro_torch.fleet import policy_bound_exact
    return {f"{fam}/{ts}": float(policy_bound_exact(
        fam, HULL_POLICY, HULL_EPS_B, topo_seed=ts))
        for fam in HULL_FAMILIES for ts in HULL_TOPO_SEEDS}


def hull_probes(bounds: dict) -> dict:
    """{"<family>/<topo_seed>": [k_lo, k_mid, k_hi]}: the grid indices of
    the first three probes of the cell's bisection (its first bracket's
    ends, then their midpoint); a probe's rate is k x rel_tol x bound."""
    from repro_torch.fleet.frontier import bracket_indices
    out = {}
    for key, bound in bounds.items():
        lo, hi = bracket_indices(bound, HULL_REL_TOL * bound, HULL_BRACKET)
        out[key] = [lo, (lo + hi) // 2, hi]
    return out


def hull_buckets() -> tuple:
    """([pad dims of each shape bucket], {"<family>/<topo_seed>": bucket})
    by the program's bucketing rule, as the atlas cuts them."""
    from repro_torch.fleet import get_scenario
    from repro_torch.fleet.batching import make_buckets
    keys, problems = [], []
    for fam in HULL_FAMILIES:
        sc = get_scenario(fam)
        for ts in HULL_TOPO_SEEDS:
            keys.append(f"{fam}/{ts}")
            problems.append(sc.build(ts))
    dims, assignment = make_buckets(problems, HULL_BUCKETS)
    pads = [{"n_nodes": d.n_nodes, "n_edges": d.n_edges, "n_comp": d.n_comp}
            for d in dims]
    return pads, dict(zip(keys, assignment))


def paper_topologies() -> dict:
    from repro_torch.core.graph import paper_grid_problem
    return {"C2": topology(paper_grid_problem(C=2.0, R=5.0), "poisson",
                           "static", False),
            "C3": topology(paper_grid_problem(C=3.0, R=5.0), "poisson",
                           "static", False)}


def atlas_hull() -> dict:
    bounds = hull_bounds()
    pads, buckets = hull_buckets()
    return {
        "name": "atlas_hull",
        "source": ("arXiv:1601.03876 networks via the repo's capacity "
                   "atlas, ATLAS_SWEEP of benchmarks/bench_atlas.py: 9 "
                   "families, topo seeds 0-55, seeds 0-2, pi3, eps_B 0.05, "
                   "T 4096, 10% probe grid, 3 buckets"),
        "deployment": ("a researchers' capacity atlas on one card: 504 "
                       "(family, topo seed) cells of 3 arrival seeds each, "
                       "every cell padded to its shape bucket, one batch "
                       "per (policy group, bucket)"),
        "guarantees": ("every lane is its own simulation: its metrics and "
                       "verdict depend only on its topology, rate and seed; "
                       "fluid float32 queues; pairs combined fifo; "
                       "wireless_grid under node-exclusive interference"),
        "policy": HULL_POLICY, "eps_b": HULL_EPS_B,
        "T": 4096, "chunk": 512, "early_stop": True,
        "rel_tol": HULL_REL_TOL, "bracket": list(HULL_BRACKET),
        "families": list(HULL_FAMILIES),
        "topo_seeds": list(HULL_TOPO_SEEDS),
        "dtype": "float32",
        "bucket_pads": pads,
        "buckets": buckets,
        "bounds": bounds,
        "probes": hull_probes(bounds),
        "topologies": hull_topologies(),
    }


def paper_grid() -> dict:
    return {
        "name": "paper_grid",
        "source": ("https://arxiv.org/abs/1601.03876 Sec. V, Fig. 5(a)-(b): "
                   "the 4x4 grid, R=5, C=2 and C=3, their rate grids, "
                   "eps_B 0.01, T=2500"),
        "deployment": "the paper's figure sweep: one batch of 9 rates per C",
        "guarantees": ("common random numbers across the rates of a sweep; "
                       "fluid float32 queues; pairs combined fifo"),
        "eps_b": 0.01, "T": 2500,
        "dtype": "float32",
        "rates": PAPER_RATES,
        "topologies": paper_topologies(),
    }


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    for name, data in (("atlas_hull", atlas_hull()),
                       ("paper_grid", paper_grid())):
        path = HERE / "configs" / f"{name}.json"
        path.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
        print(f"wrote {path.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
