"""The frozen deployments against the live scenario factories and LP they
were exported from."""
from __future__ import annotations

import pytest

from portbench import export
from portbench.harness import HERE, load_json


def test_hull_topologies_are_the_factories():
    frozen = load_json(HERE / "configs" / "atlas_hull.json")
    assert frozen["topologies"] == export.hull_topologies()
    assert frozen["families"] == list(export.HULL_FAMILIES)
    assert len(frozen["topologies"]) == 504


def test_hull_buckets_and_probes_are_the_atlas():
    frozen = load_json(HERE / "configs" / "atlas_hull.json")
    pads, buckets = export.hull_buckets()
    assert frozen["bucket_pads"] == pads and frozen["buckets"] == buckets
    assert len(pads) == export.HULL_BUCKETS
    assert frozen["probes"] == export.hull_probes(frozen["bounds"])
    for key, topo in frozen["topologies"].items():
        pad = pads[buckets[key]]
        assert topo["n_nodes"] <= pad["n_nodes"]
        assert len(topo["edges"]) <= pad["n_edges"]
        assert len(topo["comp_nodes"]) <= pad["n_comp"]


def test_paper_grid_is_the_factory():
    frozen = load_json(HERE / "configs" / "paper_grid.json")
    assert frozen["topologies"] == export.paper_topologies()
    assert frozen["rates"] == export.PAPER_RATES


@pytest.mark.parametrize("family", export.HULL_FAMILIES)
def test_hull_bounds_are_the_exact_lp(family):
    from repro_torch.fleet import policy_bound_exact
    frozen = load_json(HERE / "configs" / "atlas_hull.json")["bounds"]
    for ts in (0, 7, 55):
        assert frozen[f"{family}/{ts}"] == policy_bound_exact(
            family, export.HULL_POLICY, export.HULL_EPS_B, topo_seed=ts)
