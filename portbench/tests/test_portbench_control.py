"""The control, the reference with its carry held in bfloat16 in the
program's place, fails the cell's comparison; the same comparison passes
the float32 reference against itself.  (On the card the control is read at
the cells' own sizes by `portbench/readings.py`.)"""
from __future__ import annotations

import pytest

from portbench import harness

SIZES = {"paper_grid.trace_pi3": 600, "paper_grid.trace_pi3bar": 600,
         "atlas_hull.fleet": 2048}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_is_not_correct(tiny, name):
    entry = harness.make_entry(tiny(name, SIZES[name]), 3, "cpu")
    idx = entry.sample()
    ref = entry.reference(idx)
    checks, failed = harness.judge(entry, [entry.control(idx)], ref)
    assert failed == 1, checks
    checks, failed = harness.judge(entry, [ref], ref)
    assert failed == 0, checks
