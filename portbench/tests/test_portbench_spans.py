"""The span readers (`portbench/spanrun.py`) on hand-made span lists with
known answers, through the harness's traced run, and the window's
reductions by span on a hand-made trace."""
from __future__ import annotations

import types

import pytest

from portbench import harness, spanrun
from portbench.tracing import Trace

MS = 1_000_000


def _span(name, t0, t1, d=None, sid=0, parent=None):
    r = {"name": name, "id": sid, "parent": parent, "run": 0,
         "t0_ns": int(t0 * MS), "t1_ns": int(t1 * MS)}
    if d is not None:
        r["d0_ns"], r["d1_ns"] = int(d[0] * MS), int(d[1] * MS)
    return r


#: One 10 ms fleet run: two chunks, each followed by the early stop's
#: read; the device works 2.5 + 3.8 ms of it.
FLEET = [_span("fleet.run", 0, 10, sid=0),
         _span("fleet.build", 0, 0.5, sid=1, parent=0),
         _span("fleet.chunk", 1, 2, (1.5, 4), sid=2, parent=0),
         _span("fleet.readback", 2, 4, sid=3, parent=0),
         _span("fleet.chunk", 4, 5, (4.2, 8), sid=4, parent=0),
         _span("fleet.readback", 5, 8, sid=5, parent=0)]
#: Two sweeps of one block each; the second block's device work ends
#: after its sweep has returned.
TRACE = [_span("trace.sweep", 0, 2, sid=0),
         _span("trace.block", 0.5, 1, (0.6, 2), sid=1, parent=0),
         _span("trace.sweep", 2, 4, sid=2),
         _span("trace.block", 2.5, 3, (3, 5), sid=3, parent=2)]


@pytest.mark.parametrize("metric, spans, want", [
    ("engine.untraced_idle", FLEET, 100 * (1 - 6.3 / 10)),
    ("engine.entry_host_ms", FLEET, 10 - 2 - 5),
    ("trace.untraced_idle", TRACE, 100 * (1 - 3.4 / 5)),
    ("trace.entry_host_ms", TRACE, 4 - 1),
])
def test_each_reader_on_a_hand_made_span_run(metric, spans, want):
    read = harness.metric_reader(metric)
    assert read(types.SimpleNamespace(spans=spans)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["engine.untraced_idle",
                                    "engine.entry_host_ms",
                                    "trace.untraced_idle",
                                    "trace.entry_host_ms"])
def test_a_reader_with_nothing_to_read_returns_none(metric):
    """No span run (no harness frame above the reader, or a program
    without spans) and a run without the cell's spans read as nothing."""
    read = harness.metric_reader(metric)
    assert read(types.SimpleNamespace()) is None
    other = TRACE if metric.startswith("engine") else FLEET
    assert read(types.SimpleNamespace(spans=other)) is None


def test_gaps_and_graph_launches_by_span():
    tr = Trace(device=[("k", 1_000_000, 1_500_000),
                       ("k", 1_600_000, 2_000_000),
                       ("k", 9_000_000, 9_500_000)],
               host=[("cudaGraphLaunch", 1_100_000, 1_200_000),
                     ("cudaGraphLaunch", 4_100_000, 4_200_000),
                     ("cudaGraphLaunch", 8_700_000, 8_800_000)],
               window_start=0, window_end=10_000_000)
    # Gaps, each by the innermost span at its middle: [0, 1) ms the
    # build's, [1.5, 1.6) the first chunk's, [2, 9) the second read-back's,
    # [9.5, 10) the run's alone.
    assert dict(spanrun.gaps_by_span(tr, FLEET)) == pytest.approx(
        {"fleet.build": 1e-3, "fleet.chunk": 1e-4, "fleet.readback": 7e-3,
         "fleet.run": 5e-4})
    assert spanrun.gaps_by_span(tr, []) == [["host idle",
                                             pytest.approx(8.6e-3)]]
    assert spanrun.launches_inside(tr, FLEET, ("fleet.chunk",)) == {
        "graph_launches": 3, "inside": 2, "largest_miss_ns": 3_800_000}


@pytest.mark.parametrize("name, spans, metrics", [
    ("atlas_hull.fleet", FLEET, {"engine.untraced_idle": 37.0,
                                 "engine.entry_host_ms": 3.0}),
    ("paper_grid.trace_pi3bar", TRACE, {"trace.untraced_idle": 32.0,
                                        "trace.entry_host_ms": 3.0}),
])
def test_the_traced_run_reads_the_span_run_of_its_own_entry(
        tiny, monkeypatch, name, spans, metrics):
    """`harness.run_cell`'s traced branch hands each span reader a
    `Reading` without spans; the reader finds the run's entry and device
    in the harness's frame and makes one span run on them, shared by the
    cell's span metrics.  A renamed local of `run_cell` fails here."""
    calls = []

    def fake_span_run(entry, device, settle=0):
        calls.append((entry, device, settle))
        return spans
    monkeypatch.setattr(spanrun, "span_run", fake_span_run)
    out = harness.run_cell(name, 5, 0.01, True, device="cpu",
                           cell=tiny(name, 128))
    assert out.correct
    assert {k: v["value"] for k, v in out.metrics.items()} == \
        pytest.approx(metrics)
    assert len(calls) == 1
    entry, device, settle = calls[0]
    assert entry.metric in {m["name"] for m in
                            harness.cell_spec(name)["end_to_end"]}
    assert device == "cpu" and settle == 1
