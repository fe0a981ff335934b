"""The slot-step kernel's bytes and the peaks table, against hand counts."""
from __future__ import annotations

from portbench.harness import HERE, load_json
from portbench.roofline import bp_slot_step


def test_bytes_at_the_hull_match_the_hand_count():
    # Per lane: state 288 floats in and out (2,304 B); problem 1,068 B
    # (edges 408, edge_cap and edge_mask 408, s1/s2/dest 12, comp_nodes 16,
    # comp_caps and comp_mask 32, sink 192); arrivals, eps_b and the
    # regulator's 4 bits 24 B; metrics 32 B.  3,428 B x 1,512 lanes.
    assert bp_slot_step.bytes_moved(1512, 16, 51, 4, True) == 3428 * 1512
    assert bp_slot_step.bytes_moved(1512, 16, 51, 4, True) == 5_183_136


def test_bytes_at_the_paper_grid_match_the_hand_count():
    # Problem: edges 192, edge_cap and edge_mask 192, 12, 16, 32, sink 192.
    per_lane = 2304 + (192 + 192 + 12 + 16 + 32 + 192) + 24 + 32
    assert bp_slot_step.bytes_moved(9, 16, 24, 4, True) == 9 * per_lane
    assert bp_slot_step.bytes_moved(9, 16, 24, 4, False) == 9 * (per_lane - 16)


def test_a_shared_problem_is_read_once():
    # The trace simulator's 9 rates share one problem of 636 B.
    problem = 192 + 192 + 12 + 16 + 32 + 192
    assert bp_slot_step.bytes_moved(9, 16, 24, 4, True, True) == \
        9 * (2304 + 24 + 32) + problem
    assert bp_slot_step.bytes_moved(9, 16, 24, 4, True, True) == 21_876


def test_the_bound_is_the_bytes_time_at_the_published_peaks():
    peaks = load_json(HERE / "roofline" / "peaks.json")["NVIDIA H100 80GB HBM3"]
    shapes = {"B": 1512, "N": 16, "E": 51, "NC": 4, "regulated": True}
    t = bp_slot_step.least_seconds(shapes, peaks)
    assert abs(t - 5_183_136 / 3.35e12) < 1e-15
    assert bp_slot_step.flops(**shapes) / peaks["f32_flops_per_s"] < t / 10
