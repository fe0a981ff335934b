"""A run with its timed path broken underneath comes out not correct: a
slot step that returns its state unchanged, and an answer altered where it
is produced.  The harness runs on the CPU here (it skips only its look for
a card)."""
from __future__ import annotations

import pytest

from portbench import harness


def _frozen_step(real):
    def step(pp, cfg, state, *a, **kw):
        _, m = real(pp, cfg, state, *a, **kw)
        return state, m
    return step


@pytest.mark.parametrize("name,module", [
    ("paper_grid.trace_pi3", "repro_torch.sim.simulator"),
    ("atlas_hull.fleet", "repro_torch.fleet.engine")])
def test_a_step_that_keeps_its_state(tiny, monkeypatch, name, module):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "slot_step", _frozen_step(mod.slot_step))
    out = harness.run_cell(name, 8, 0.01, False, device="cpu",
                           cell=tiny(name, 256))
    assert not out.correct and out.failed == out.attempted


def test_an_altered_fleet_answer(tiny, monkeypatch):
    from repro_torch.fleet import engine
    real = engine.StreamRunner.finalize

    def finalize(self, inp, c):
        out = real(self, inp, c)
        out["useful_rate"] = out["useful_rate"] + 0.01
        return out
    monkeypatch.setattr(engine.StreamRunner, "finalize", finalize)
    name = "atlas_hull.fleet"
    out = harness.run_cell(name, 8, 0.01, False, device="cpu",
                           cell=tiny(name, 256))
    assert not out.correct


def test_an_altered_trace_answer(tiny, monkeypatch):
    from repro_torch import sim
    real = sim.sweep_rates

    def sweep(*a, **kw):
        res = real(*a, **kw)
        res.delivered_useful[0, -1] += 1.0
        return res
    monkeypatch.setattr(sim, "sweep_rates", sweep)
    name = "paper_grid.trace_pi3bar"
    out = harness.run_cell(name, 8, 0.01, False, device="cpu",
                           cell=tiny(name, 128))
    assert not out.correct
