"""The port's telemetry plane against the JAX reference, on the CPU.

The port's schema is the reference's (same digest, and its records pass
the reference's `validate_stream` and `scripts/check_stream.py`); turning
a stream on leaves `run_fleet`, `run_serving`, `find_lambda_max` and
`sweep_lambda_max` bit-identical with no extra launcher; the emitter's
worker delivers every record in order to a slow consumer and raises what
it met; the follow view renders port records.  `serving_report` at
`benchmarks/bench_serving.py`'s SERVING_SMOKE meets that file's gates.
The reference is read through its schema module, which imports no JAX,
so the `gpu`-marked tests here (the graphed serving chunk, the snapshot
against the next replay) also run on a card's machine without JAX.
"""
import importlib.util
import pathlib
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.obs import schema as jschema  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.fleet.scenarios import event_code  # noqa: E402
from repro_torch.obs import emitter, follow, schema  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 0.05


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_jobs():
    return [tfleet.FleetJob("paper_grid", "pi3_reg", lam=lam, seed=s,
                            eps_b=0.05)
            for lam, s in ((4.0, 0), (7.6, 1), (11.0, 2))]


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def test_schema_is_the_references():
    assert schema.schema_digest() == jschema.schema_digest() == \
        schema.BLESSED_DIGESTS[schema.SCHEMA_VERSION]
    assert schema.STREAM_KINDS == jschema.STREAM_KINDS
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert schema.BLESSED_DIGESTS == jschema.BLESSED_DIGESTS
    rec = schema.make_record(
        "fleet", group=0, chunk=0, t=64, n_sims=4, useful_rate_med=0.5,
        backlog_med=0.1, max_queue_med=3.0, drift_med=-0.01, n_decided=1,
        verdicts={"STABLE": 1})
    assert jschema.validate_record(rec) == []
    assert schema.jsonl_line(rec) == jschema.jsonl_line(rec)
    with pytest.raises(ValueError, match="unexpected key"):
        schema.make_record("fleet", bogus=1, **{k: rec[k] for k in rec
                                                if k not in (
                                                    "schema_version",
                                                    "kind")})


# ---------------------------------------------------------------------------
# Stream on against stream off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("early_stop", [False, True])
def test_fleet_stream_bit_identical(tmp_path, early_stop):
    jobs = _fleet_jobs()
    kw = dict(T=768, chunk=128, device="cpu", early_stop=early_stop,
              verdict=tfleet.VerdictConfig(window=64, burn_in=128))
    off = tfleet.run_fleet(jobs, **kw)
    path = tmp_path / "FLEET_stream.jsonl"
    on = tfleet.run_fleet(jobs, **kw, stream_path=str(path))
    assert on.metrics == off.metrics and off.stream_records == []
    assert on.n_step_compiles == off.n_step_compiles
    assert on.slot_steps == off.slot_steps
    assert len(on.stream_records) == on.slot_steps // 128
    assert jschema.validate_stream(on.stream_records) == []
    assert schema.read_stream_jsonl(str(path)) == on.stream_records
    check = _load(ROOT / "scripts" / "check_stream.py", "check_stream")
    assert check.check_file(str(path)) == []
    last = on.stream_records[-1]
    assert last["t"] == on.slot_steps and last["n_sims"] == 3
    if early_stop:
        assert on.slot_steps < 768 and last["n_decided"] == 3


def test_serving_stream_bit_identical(tmp_path):
    jobs = [ts.ServingJob(trace=tr, lam=lam, seed=s)
            for tr, lam, s in (("bursty", 3.0, 0), ("bursty", 9.5, 1),
                               ("bursty_mix", 9.5, 2))]
    kw = dict(T=768, chunk=128, device="cpu")
    off = ts.run_serving(jobs, **kw)
    path = tmp_path / "SERVING_stream.jsonl"
    on = ts.run_serving(jobs, **kw, stream_path=str(path))
    assert on.metrics == off.metrics
    assert on.n_step_compiles == off.n_step_compiles
    assert len(on.stream_records) == on.n_programs * (768 // 128) == 12
    assert jschema.validate_stream(on.stream_records) == []
    assert schema.read_stream_jsonl(str(path)) == on.stream_records
    assert ts.write_stream_jsonl(on, str(tmp_path / "again.jsonl")) == 12
    assert (tmp_path / "again.jsonl").read_text() == path.read_text()
    by_group = {}
    for r in on.stream_records:
        by_group.setdefault(r["group"], []).append(r)
    assert sorted(by_group) == [0, 1]
    assert [r["chunk"] for r in by_group[0]] == list(range(6))
    assert by_group[0][-1]["n_sims"] == 2 and by_group[1][-1]["n_sims"] == 1


def test_atlas_and_frontier_streams_bit_identical(tmp_path):
    cells = tfleet.registry_cells(("paper_grid", "ring"), topo_seeds=(0, 1),
                                  eps_b=0.05)
    kw = dict(seeds=(0,), T=512, chunk=128, rel_tol=0.1, max_calls=4,
              device="cpu",
              verdict=tfleet.VerdictConfig(window=64, burn_in=128))
    off = tfleet.sweep_lambda_max(cells, **kw)
    path = tmp_path / "ATLAS_stream.jsonl"
    on = tfleet.sweep_lambda_max(cells, **kw, stream_path=str(path))
    assert on.rows == off.rows and off.stream_records == []
    assert (on.n_launches, on.n_step_compiles, on.n_rewrites) == \
        (off.n_launches, off.n_step_compiles, off.n_rewrites)
    assert len(on.stream_records) == on.n_launches
    assert jschema.validate_stream(on.stream_records) == []
    assert schema.read_stream_jsonl(str(path)) == on.stream_records
    for r in on.stream_records:
        assert r["t"] == (r["chunk"] + 1) * 128
    last = on.stream_records[-1]
    assert last["n_done_cells"] == 4 and last["n_active_cells"] == 0
    assert set(last["families"]) == {"paper_grid", "ring"}

    seen = []
    f_kw = dict(eps_b=0.05, seeds=(0,), T=512, chunk=128, rel_tol=0.1,
                max_calls=4, device="cpu",
                verdict=tfleet.VerdictConfig(window=64, burn_in=128))
    f_off = tfleet.find_lambda_max("paper_grid", "pi3", **f_kw)
    f_on = tfleet.find_lambda_max("paper_grid", "pi3", **f_kw,
                                  stream_log=seen.append)
    assert f_on == f_off
    assert sum(r["chunk"] == 0 for r in seen) == f_on.n_calls
    assert all(jschema.validate_record(r) == [] for r in seen)


def test_slow_consumer_gets_every_record_in_order():
    """A ``stream_log`` that sleeps on every record holds the engine back
    (two snapshot buffers) but loses and reorders nothing; the records it
    saw are the run's, in the sink's order.  The interpreter switches
    threads every 10 us meanwhile, so a lost update between the host loop
    and the worker would show."""
    seen, threads = [], set()

    def slow(rec):
        threads.add(threading.get_ident())
        time.sleep(0.02)
        seen.append(rec)
    jobs = _fleet_jobs()[:2]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = tfleet.run_fleet(jobs, T=1024, chunk=32, device="cpu",
                               stream_log=slow)
    finally:
        sys.setswitchinterval(interval)
    assert seen == res.stream_records
    assert [r["chunk"] for r in seen] == list(range(32))
    assert [r["t"] for r in seen] == [32 * (i + 1) for i in range(32)]
    assert threading.get_ident() not in threads


def test_emitter_raises_what_its_worker_met():
    """A probe the record assembler cannot read fails on the worker
    thread; the failure surfaces at `close`, and no record is written."""
    sink = emitter.StreamSink()
    runner = tfleet.make_stream_runner(PolicyConfig("pi3"), T=64, chunk=32)
    em = emitter.ChunkEmitter("fleet", 0, 1, runner, sink)
    bad = {"t": torch.tensor([32], dtype=torch.int32)}     # leaves missing
    em.emit(bad)
    with pytest.raises(RuntimeError, match="stream worker failed"):
        em.close()
    assert sink.records == []


# ---------------------------------------------------------------------------
# The follow view and the bench gates
# ---------------------------------------------------------------------------

def test_follow_renders_port_records(tmp_path, capsys):
    jobs = [ts.ServingJob(trace="bursty", lam=9.0, seed=s) for s in (0, 1)]
    path = tmp_path / "SERVING_stream.jsonl"
    ts.run_serving(jobs, T=256, chunk=64, device="cpu",
                   stream_path=str(path))
    fleet_path = tmp_path / "FLEET_stream.jsonl"
    tfleet.run_fleet(_fleet_jobs(), T=256, chunk=64, device="cpu",
                     stream_path=str(fleet_path))
    frame = follow.render(schema.read_stream_jsonl(str(path)))
    assert frame.startswith("serving g0  chunk    3  t=     256  sims=   2")
    assert follow.main([str(path), str(fleet_path)]) == 0
    out = capsys.readouterr().out
    assert "serving g0" in out and "fleet   g0" in out
    assert "failed schema validation" not in out


def test_serving_report_meets_the_bench_gates_at_the_smoke():
    """`benchmarks/bench_serving.py`'s SERVING_SMOKE on the port's own
    noise (T=4096, 2 rates x 2 seeds): at 0.95x the bound delivered /
    bound >= 0.9, shed <= 0.02, p99 <= 512 slots; at 1.3x shed >= 0.10 and
    the admitted rate <= 1.05 x the bound; one record per chunk."""
    bench = _load(ROOT / "benchmarks" / "bench_serving.py", "bench_serving")
    rep = ts.serving_report(**bench.SERVING_SMOKE, stream=True,
                            device="cpu")
    bound = rep["bound_exact"]
    nom = rep["rows"]["0.95"]
    assert nom["delivered_over_bound"] >= bench.SERVING_MIN_RATIO
    assert nom["shed_frac_max"] <= bench.SERVING_MAX_SHED
    assert nom["p99_sojourn_max"] <= bench.SERVING_P99_MAX
    over = rep["rows"][f"{bench.SERVING_OVERLOAD_FRAC:g}"]
    assert over["shed_frac"] >= bench.SERVING_OVERLOAD_MIN_SHED
    assert over["admitted_rate"] <= \
        bound * bench.SERVING_OVERLOAD_RATE_SLACK
    res = rep["result"]
    assert len(res.stream_records) == res.T // bench.SERVING_SMOKE["chunk"]
    assert jschema.validate_stream(res.stream_records) == []


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_snapshot_survives_the_next_replay_on_the_card():
    """The emitter's snapshot of a chunk's probe is ordered before the next
    chunk's in-place replay: the records of a graphed run whose host runs
    ahead of the card equal records assembled from a second run that
    synchronises and reads the probe after every chunk, and the metrics
    equal the stream-off run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = [ts.ServingJob(trace="bursty_mix", lam=lam, seed=s)
            for lam, s in ((7.6, 0), (10.4, 1), (5.0, 2), (9.0, 3))]
    on = ts.run_serving(jobs, T=1024, chunk=128, stream=True)
    off = ts.run_serving(jobs, T=1024, chunk=128)
    assert on.metrics == off.metrics
    assert on.n_step_compiles == off.n_step_compiles == 1
    runner = ts.make_serving_runner(PolicyConfig("pi3_reg", eps_b=0.05),
                                    ts.get_trace("bursty_mix"), T=1024,
                                    chunk=128)
    scen = tfleet.get_scenario("paper_grid")
    inp = runner.make_inputs(
        tfleet.stack_problems([scen.build(0)] * 4, on.dims, "cuda"),
        [j.lam for j in jobs], [0.05] * 4,
        [event_code(scen.events)] * 4,
        [j.seed for j in jobs])
    launch = tfleet.engine.launch_for(runner, inp)
    launch.start(inp)
    prev = None
    for c in range(runner.n_chunks):
        launch.step()
        torch.cuda.synchronize()
        p = {k: v.cpu().numpy() for k, v in
             runner.probe(launch.carry).items()}
        assert on.stream_records[c] == emitter._serving_record(
            0, c, runner, p, prev, 4), c
        prev = p
    assert all(torch.isfinite(x).all() for x in tree_leaves(launch.carry)
               if x.is_floating_point())


@pytest.mark.gpu
def test_graphed_serving_chunk_equals_eager_on_the_card():
    """On the card a serving `GroupLaunch` replays one captured graph; a
    second launcher from the same start stepped by the eager
    `chunk_step` holds the same carry bit for bit after every chunk, and
    a second `start` (lower rates and new seeds, copied in place into the
    tables sized by the first) replays the same graph to the eager result
    again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    dims = tfleet.PadDims(16, 51, 4)
    runner = ts.make_serving_runner(PolicyConfig("pi3_reg", eps_b=EPS),
                                    ts.get_trace("bursty_mix"), T=512,
                                    chunk=128)
    scen = ("paper_grid", "ring", "ge_grid", "fat_tree")
    pp = tfleet.stack_problems([tfleet.get_scenario(s).build(0)
                                for s in scen], dims, dev)
    ek = [event_code(tfleet.get_scenario(s).events) for s in scen]
    graphed, eager = (tfleet.GroupLaunch(runner, 4, dims, dev,
                                         tuple(sorted(set(ek))))
                      for _ in range(2))
    for lam, seed in (([9.0, 1.5, 6.0, 4.0], [7, 8, 9, 10]),
                      ([7.5, 2.5, 5.0, 3.0], [0, 1, 2, 3])):
        inp = runner.make_inputs(pp, lam, [EPS] * 4, ek, seed)
        for launch in (graphed, eager):
            launch.start(inp)
        for c in range(runner.n_chunks):
            graphed.step()
            runner.chunk_step(eager.inp, eager.carry)
            for a, b in zip(tree_leaves(graphed.carry),
                            tree_leaves(eager.carry)):
                assert torch.equal(a, b), c
    assert graphed.n_compiles == 1 and graphed.replays == 2 * 4 * 2 - 1
