"""The harness end to end at tiny sizes on the CPU: every cell of
BENCHMARK.json found by name, a measured and a traced run, the result's
fields, and a sound run judged correct."""
from __future__ import annotations

import json

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    cell = harness.cell_spec(name)
    assert harness.make_entry(cell, 1, "cpu").metric in {
        m["name"] for m in cell["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert set(cell["params"]["limits"])


@pytest.mark.parametrize("name", CELLS)
def test_a_measured_run_at_a_tiny_size(tiny, name):
    cell = tiny(name, 128)
    out = harness.run_cell(name, 2_147_483_701, 0.01, False, device="cpu",
                           cell=cell)
    assert out.correct and out.failed == 0 and out.attempted >= 1
    assert set(out.metrics) == {m["name"] for m in cell["end_to_end"]}
    assert all(m["value"] > 0 for m in out.metrics.values())
    assert [c[0] for c in out.checks] == list(cell["params"]["limits"])
    json.dumps(out.checks)


def test_a_traced_run_at_a_tiny_size(tiny):
    name = "paper_grid.trace_pi3bar"
    out = harness.run_cell(name, 5, 0.01, True, device="cpu",
                           cell=tiny(name, 128))
    assert out.correct
    # The CPU trace holds no device activity: nothing to read, so no
    # per-layer number (never a 0 for a share).
    assert out.metrics == {}
    assert out.device["busy_s"] == 0.0 and out.device["window_s"] > 0
    assert set(out.breakdown) == {"device_ops", "idle_gaps"}


def test_the_run_line_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
