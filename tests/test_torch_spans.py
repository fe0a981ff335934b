"""The run loops' spans and counters (`repro_torch.obs.spans`).

Recording off changes nothing and records nothing; on, the fleet's and
the trace simulator's spans nest under their run, the fleet's blocking
reads are counted where they happen, and the host clock is the one
`torch.profiler` stamps its events with.  The card's device intervals are
checked by the one `gpu` test (no JAX in this file: the card's machine has
none)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core import PolicyConfig, paper_grid_problem  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.sim import sweep_rates  # noqa: E402

DIMS = tfleet.PadDims(16, 51, 4)
VERDICT = tfleet.VerdictConfig(window=64, burn_in=128)


def _jobs():
    return [tfleet.FleetJob("paper_grid", "pi3", lam=lam, seed=s,
                            eps_b=0.05)
            for lam, s in ((2.0, 0), (12.0, 3), (6.0, 5))]


def _fleet(device="cpu", T=384, chunk=64):
    return tfleet.run_fleet(_jobs(), T=T, chunk=chunk, device=device,
                            dims=DIMS, early_stop=True, verdict=VERDICT)


def _sweep(device="cpu", T=150):
    return sweep_rates(paper_grid_problem(C=3.0),
                       PolicyConfig(name="pi3", eps_b=0.01),
                       [4.0, 8.0, 10.5], T=T, seed=7, device=device)


def _ancestors(rec: dict, by_id: dict):
    while rec["parent"] is not None:
        rec = by_id[rec["parent"]]
        yield rec


def test_recording_off_records_nothing_and_changes_no_bit():
    assert spans._active is None
    assert spans.span("fleet.chunk") is spans.span("trace.block")
    spans.count("host.readback_bytes")       # no recorder: nothing to add
    off_fleet, off_sweep = _fleet(), _sweep()
    with spans.recording() as rec:
        on_fleet, on_sweep = _fleet(), _sweep()
    assert spans._active is None
    assert on_fleet.metrics == off_fleet.metrics
    for a, b in zip(on_sweep[1:], off_sweep[1:]):
        assert torch.equal(a, b)
    assert rec.spans() and rec.counters()["host.readback_bytes"] > 0
    with spans.recording() as empty:
        pass
    assert empty.spans() == [] and empty.counters() == {}


def test_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans._active is None


@pytest.mark.parametrize("path, outer, inner, n_inner", [
    ("fleet", "fleet.run", "fleet.chunk", None),
    # On the CPU the trace runner is the eager loop: no blocks to span.
    ("trace", "trace.sweep", "trace.arrivals", 1),
])
def test_spans_nest_under_their_run(path, outer, inner, n_inner):
    call = _fleet if path == "fleet" else _sweep
    with spans.recording() as rec:
        call()
        call()
    recs = rec.spans()
    by_id = {r["id"]: r for r in recs}
    runs = [r for r in recs if r["name"] == outer]
    assert len(runs) == 2 and len({r["run"] for r in runs}) == 2
    assert all(r["run"] == r["id"] and r["parent"] is None for r in runs)
    inners = [r for r in recs if r["name"] == inner]
    assert inners
    for r in inners:
        up = [a["name"] for a in _ancestors(r, by_id)]
        assert up[-1] == outer and by_id[r["run"]]["name"] == outer
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= p["t1_ns"]
    if n_inner is not None:
        for run in runs:
            assert sum(r["run"] == run["id"] for r in inners) == n_inner
    if path == "fleet":
        assert {"fleet.build", "fleet.start", "fleet.readback",
                "fleet.finalize"} <= {r["name"] for r in recs}


def test_early_stop_readbacks_are_counted_where_they_happen():
    """One group: each chunk after the first is preceded by the verdict
    read, and so is the early stop itself; `start` reads the arrival
    codes and the rates, `finalize` every metric in one copy.  Each read
    is one `fleet.readback` span, and its bytes are counted."""
    T, chunk = 1024, 64
    with spans.recording() as rec:
        res = _fleet(T=T, chunk=chunk)
    recs = rec.spans()
    by_id = {r["id"]: r for r in recs}
    chunks = sum(r["name"] == "fleet.chunk" for r in recs)
    reads = [by_id[r["parent"]]["name"] for r in recs
             if r["name"] == "fleet.readback"]
    stopped = chunks < T // chunk
    assert res.n_programs == 1 and stopped
    assert sorted(set(reads)) == ["fleet.finalize", "fleet.run",
                                  "fleet.start"]
    early = reads.count("fleet.run")
    assert early == chunks - 1 + stopped
    assert reads.count("fleet.start") == 2
    assert reads.count("fleet.finalize") == 1
    assert len(reads) == early + 3
    n = len(_jobs())
    assert rec.counters() == {"host.readback_bytes": early + n * (4 + 4) +
                              len(res.metrics[0]) * n * 4}


def test_poisson_widths_in_one_call_are_each_rates_own():
    from scipy import stats

    from repro_torch.sim import workload
    rates = np.concatenate([np.random.default_rng(3).uniform(0, 60, 4000),
                            [0.0, -1.0, 1e-9, 0.5, 500.0]])
    alone = [int(stats.poisson.isf(workload.POISSON_TAIL, r)) + 2
             if r > 0 else 1 for r in rates]
    assert workload.poisson_widths(rates).tolist() == alone


def test_host_clock_is_the_profilers():
    """A span opened inside a `record_function` window lies within the
    window's kineto interval, with no offset fitted (5 ms of slack)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    slack = 5_000_000
    with spans.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with record_function(f"window{i}"):
                with spans.span(f"inside{i}"):
                    torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    got = {r["name"]: r for r in rec.spans()}
    for i in range(5):
        ev = events[f"window{i}"]
        s0, s1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        r = got[f"inside{i}"]
        assert s0 - slack <= r["t0_ns"] <= r["t1_ns"] <= s1 + slack


@pytest.mark.gpu
def test_device_intervals_on_the_card():
    """On the card: every chunk's and block's device interval is resolved
    and lies inside its run's wall (a sweep returns with its last blocks
    queued: up to the synchronise after it), the chunk spans number the
    chunks the launches ran, and the launches' replays are one a chunk
    span (64-slot chunks) and one a full 64-slot block of each sweep's
    load, with no graph captured again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import gc
    from repro_torch.fleet.capture import CapturedSlots
    _fleet("cuda")
    _sweep("cuda")                              # builds and captures
    torch.cuda.synchronize()
    launches = [o for o in gc.get_objects() if isinstance(o, CapturedSlots)]
    before = sum(o.replays for o in launches)
    with spans.recording(device_events=True) as rec:
        res = _fleet("cuda")
        _sweep("cuda")
        torch.cuda.synchronize()
        synced = rec.now_ns()
    recs = rec.spans()
    by_id = {r["id"]: r for r in recs}
    for inner, outer in (("fleet.chunk", "fleet.run"),
                         ("trace.block", "trace.sweep")):
        inners = [r for r in recs if r["name"] == inner]
        assert inners
        for r in inners:
            run = by_id[r["run"]]
            assert run["name"] == outer
            end = run["t1_ns"] if outer == "fleet.run" else synced
            assert run["t0_ns"] <= r["d0_ns"] <= r["d1_ns"] <= end

    def n(name):
        return sum(r["name"] == name for r in recs)
    assert n("fleet.chunk") * 64 == res.slot_steps
    assert sum(o.replays for o in launches) - before == \
        n("fleet.chunk") + n("trace.load") * (150 // 64)
    assert n("graph.capture") == 0
