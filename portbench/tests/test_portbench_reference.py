"""The plain reference against the port's CPU path at a few lanes and
slots: the same dynamics bit for bit (scatters in list order), sums of the
state within float32 rounding."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import harness
from portbench.reference import noise


def test_noise_is_the_programs_hash():
    import torch
    from repro_torch.sim import workload
    seed = np.array([0, 5, 3 * 2_147_483_701 + 2, 123_456_789_012])
    t = np.array([0, 7, 4095, 100])
    for site, n in ((1, 1), (3, 4), (4, 51), (5, 4)):
        assert (workload.uniform(torch.as_tensor(seed), torch.as_tensor(t),
                                 site, n).numpy()
                == noise.uniform(seed, t, site, n)).all()
    assert (workload.uniform64(torch.as_tensor(seed), torch.as_tensor(t), 1,
                               1).numpy()
            == noise.uniform64(seed, t, 1, 1)).all()


def test_matching_is_the_programs():
    import torch
    from repro_torch.kernels.bp_slot.ref import greedy_maximal_matching
    from portbench.reference.slot import greedy_matching as plain
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 16, (64, 24, 2))
    # Few distinct weights, zeros among them: ties and idle links.
    weight = rng.integers(0, 4, (64, 24)).astype(np.float32)
    want = greedy_maximal_matching(
        torch.as_tensor(edges, dtype=torch.int32), torch.as_tensor(weight),
        16).numpy()
    assert (plain(edges, weight, 16) == want).all()


@pytest.mark.parametrize("name", ["paper_grid.trace_pi3",
                                  "paper_grid.trace_pi3bar"])
def test_trace_reference_against_the_port(tiny, name):
    entry = harness.make_entry(tiny(name, 200), 4_000_000_007, "cpu")
    entry.setup()
    idx = entry.sample()
    prog = entry.answers(entry.run(), idx)
    ref = entry.reference(idx)
    for k in ref:
        if k.endswith(("delivered", "delivered_useful", "computed",
                       "n_star")):
            assert (prog[k] == ref[k]).all(), k
        else:
            np.testing.assert_allclose(prog[k], ref[k], rtol=1e-6, err_msg=k)


def test_fleet_reference_against_the_port(tiny):
    cell = tiny("atlas_hull.fleet", 512)
    entry = harness.make_entry(cell, 11, "cpu")
    idx = entry.sample()
    entry.lanes = [entry.lanes[i] for i in idx]
    assert any(cell["config_data"]["topologies"][lane[0]]["wireless"]
               for lane in entry.lanes)
    entry.setup()
    lanes = list(range(len(idx)))
    prog = entry.answers(entry.run(), lanes)
    ref = entry.reference(lanes)
    for k in ("delivered", "delivered_useful", "verdict", "decided_at_slot",
              "useful_rate", "stable", "slots_saved"):
        assert (prog[k] == ref[k]).all(), k
    for k in ("mean_queue", "mean_queue_mid", "mean_queue_tail",
              "max_queue"):
        np.testing.assert_allclose(prog[k], ref[k], rtol=1e-6, err_msg=k)
