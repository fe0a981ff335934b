"""The port's capacity atlas, its group launch and its lane rewriter, on
the CPU against the JAX reference (and, marked ``gpu``, the captured
chunk against the eager one on the card).

The rewriter must write in place and leave untouched lanes bit-unchanged;
a Poisson row must depend on its own rate only; a mini atlas must equal
the port's sequential `find_lambda_max` bit for bit; the scheduler must
match the reference's where the verdicts cannot differ; and the atlas
tables must equal the reference's on the same rows.  The mini atlas
against the JAX one is `test_torch_atlas_reference.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.device import tree_leaves  # noqa: E402
from repro_torch.fleet import engine as tengine  # noqa: E402
from repro_torch.fleet.batching import from_leaves, pad_leaves  # noqa: E402
from repro_torch.fleet.scenarios import (arrival_code, arrival_rates,  # noqa: E402
                                         event_code, get_scenario)
from repro_torch.sim import workload  # noqa: E402

#: Two of tests/test_atlas.py's MINI_CELLS topologies, a grid and a cycle.
#: The eps_b values are off-default and unused by other test modules, so
#: the JAX package's memoized runners (and its compile counts) stay
#: private to each module.
MINI_FAMILIES = ("paper_grid", "ring")
MINI_EPS = 0.0522
TINY_EPS = 0.0517
#: A short-horizon mini atlas for the bit-for-bit comparison with the
#: sequential search (any horizon shows it).
EXACT_KW = dict(seeds=(0,), T=1024, chunk=128, rel_tol=0.25, max_calls=4)
#: A horizon no verdict can latch in (the earliest latch is at 6 windows):
#: every probe is UNDECIDED in both packages whatever the noise, so the
#: schedulers' control flow (buckets, re-queues, rewrites) must agree
#: exactly.
TINY_KW = dict(seeds=(0, 1), T=128, chunk=64, rel_tol=0.25, max_calls=2,
               n_buckets=2, max_requeues=1)
TINY_FAMILIES = ("paper_grid", "ring", "fat_tree")


@pytest.fixture(scope="module")
def jfleet():
    """The JAX package's fleet (imported here: the card's machine, which
    runs the ``gpu`` test, has no JAX)."""
    pytest.importorskip("jax")
    from repro import fleet
    return fleet


def _cells(pkg, families, eps_b=MINI_EPS, policy="pi3"):
    return [pkg.AtlasJob(f, policy=policy, eps_b=eps_b) for f in families]


def _batch(jobs, dims):
    pp = from_leaves([pad_leaves(get_scenario(j.scenario).build(j.topo_seed),
                                 dims) for j in jobs],
                     dims.n_nodes, dims.n_comp, "cpu")
    return tengine.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [arrival_code(get_scenario(j.scenario).arrival) for j in jobs],
        [event_code(get_scenario(j.scenario).events) for j in jobs],
        [j.seed for j in jobs])


def _snapshot(launch):
    return ([x.clone() for x in tree_leaves(launch.carry)],
            [x.clone() for x in tree_leaves(launch.inp)
             if isinstance(x, torch.Tensor)])


def test_rewriter_writes_in_place_and_spares_untouched_lanes():
    """reset gives a lane a fresh carry (t = 0) and its new rate, seed and
    Poisson row; park forces its verdict to UNSTABLE, after which the
    freeze holds its carry; every other lane keeps every bit; no tensor the
    chunk reads is rebound.  A reset lane then runs exactly as that probe
    would alone."""
    dims = tfleet.PadDims(16, 51, 4)
    jobs = [tfleet.FleetJob(f, "pi3", lam=lam, seed=s, eps_b=0.05)
            for f, lam, s in (("paper_grid", 4.0, 0), ("ring", 1.5, 1),
                              ("ge_grid", 5.0, 2), ("ring", 2.5, 3))]
    runner = tengine.make_stream_runner(
        PolicyConfig("pi3", eps_b=0.05), T=256, chunk=32,
        verdict=tengine.resolve_verdict(None, True))
    inp = _batch(jobs, dims)
    launch = tengine.GroupLaunch(runner, 4, dims, torch.device("cpu"),
                                 inp.arrival_codes, inp.event_codes)
    launch.start(inp, max_rate=6.0)
    rewrite = tfleet.make_sim_rewriter(launch)
    launch.step()
    ptrs = [x.data_ptr() for x in tree_leaves(launch.carry)] + \
        [launch.inp.lam.data_ptr(), launch.inp.seed.data_ptr(),
         launch.inp.cdf.data_ptr()]
    carry0, inp0 = _snapshot(launch)
    lam = np.array([9.0, 3.25, 9.0, 9.0], np.float32)
    seed = np.array([99, 12345, 99, 99], np.int64)
    rewrite(np.array([False, True, False, False]),
            np.array([False, False, True, False]), lam, seed)
    assert ptrs == [x.data_ptr() for x in tree_leaves(launch.carry)] + \
        [launch.inp.lam.data_ptr(), launch.inp.seed.data_ptr(),
         launch.inp.cdf.data_ptr()]
    carry1, inp1 = _snapshot(launch)
    fresh = tree_leaves(runner.init_carry(launch.inp.pp))
    leaves = tree_leaves(launch.carry)
    verdict = [i for i, x in enumerate(leaves)
               if x is launch.carry.drift.verdict][0]
    for i, (a, b, f) in enumerate(zip(carry0, carry1, fresh)):
        assert torch.equal(a[[0, 3]], b[[0, 3]])        # untouched
        assert torch.equal(b[1], f[1])                  # reset
        if i != verdict:
            assert torch.equal(a[2], b[2])              # parked
    assert int(launch.carry.drift.verdict[2]) == tengine.VERDICT_UNSTABLE
    assert int(launch.carry.t[1]) == 0
    for a, b in zip(inp0, inp1):
        assert torch.equal(a[[0, 2, 3]], b[[0, 2, 3]])
    assert float(launch.inp.lam[1]) == 3.25
    assert int(launch.inp.seed[1]) == 12345
    K = launch.inp.cdf.shape[1]
    assert torch.equal(launch.inp.cdf[1], workload.poisson_table(
        arrival_rates([3.25], [arrival_code("poisson")]), width=K)[0])

    launch.step()
    parked = tree_leaves(launch.carry)
    for a, b in zip(carry1, parked):
        assert torch.equal(a[2], b[2])           # frozen by the park
    alone_inp = _batch([dataclasses.replace(jobs[1], lam=3.25, seed=12345)],
                       dims)
    alone = runner.init_carry(alone_inp.pp)
    runner.chunk_step(alone_inp, alone)
    for a, b in zip(tree_leaves(alone), parked):
        assert torch.equal(a[0], b[1])


def test_rewrite_to_a_rate_beyond_the_table_widens_it():
    """A rate past the one `start` sized the table for widens the table,
    drops any captured graph, and leaves the other rows' draws as they
    were (their new columns are 1.0)."""
    dims = tfleet.PadDims(16, 51, 4)
    jobs = [tfleet.FleetJob("paper_grid", "pi3", lam=2.0, seed=s, eps_b=0.05)
            for s in (0, 1)]
    runner = tengine.make_stream_runner(PolicyConfig("pi3", eps_b=0.05),
                                        T=64, chunk=32)
    inp = _batch(jobs, dims)
    launch = tengine.GroupLaunch(runner, 2, dims, torch.device("cpu"),
                                 inp.arrival_codes, inp.event_codes)
    launch.start(inp)
    before = launch.inp.cdf.clone()
    launch.graph = object()                 # stands in for a capture
    launch.rewrite([False, True], [False, False], [0.0, 40.0], [0, 7])
    cdf = launch.inp.cdf
    assert cdf.shape[1] == workload.poisson_width(40.0) > before.shape[1]
    assert launch.graph is None
    assert torch.equal(cdf[0, :before.shape[1]], before[0])
    assert bool((cdf[0, before.shape[1]:] == 1.0).all())


def test_poisson_rows_depend_on_their_own_rate_only():
    """A row is the same whatever rates share its table: its own width of
    CDF values, then 1.0, so even a uniform just below 1 draws the same
    count alone and in a batch with a far larger rate."""
    rates = [0.5, 3.0, 12.0, 0.0, 40.0]
    table = workload.poisson_table(rates)
    K = table.shape[1]
    assert K == workload.poisson_width(40.0)
    u = torch.tensor([0.0, 0.3, 0.999, 1 - 1e-13, 1 - 2.0 ** -53],
                     dtype=torch.float64)
    for i, r in enumerate(rates):
        alone = workload.poisson_table([r])
        w = alone.shape[1]
        assert w == workload.poisson_width(r)
        assert torch.equal(table[i, :w], alone[0])
        assert bool((table[i, w:] == 1.0).all())
        assert torch.equal(workload.poisson_table([r], width=K)[0], table[i])
        assert torch.equal(
            workload.poisson_from_uniform(u, table[i].expand(5, -1)),
            workload.poisson_from_uniform(u, alone[0].expand(5, -1)))


def test_mini_atlas_equals_the_sequential_search_bit_for_bit():
    """Every cell of an atlas reproduces the port's own `find_lambda_max`
    at the atlas's dims on the same device, probe for probe: the same
    verdicts, decision slots and slot counts, hence the same bracket."""
    res = tfleet.sweep_lambda_max(_cells(tfleet, MINI_FAMILIES),
                                  device="cpu", **EXACT_KW)
    assert res.n_cells == 2 and res.n_programs == 1
    assert res.n_step_compiles == 1
    for row in res.rows:
        seq = tfleet.find_lambda_max(
            row.scenario, row.policy, eps_b=row.eps_b,
            topo_seed=row.topo_seed, dims=res.dims, device="cpu",
            **EXACT_KW)
        assert row.probes == seq.probes, row.scenario
        for f in ("lam_max", "lo", "hi", "ratio", "bound_exact", "n_calls",
                  "n_iters", "undecided", "hi_certain", "total_slots",
                  "full_slots", "slots_saved"):
            assert getattr(row, f) == getattr(seq, f), (row.scenario, f)
        assert seq.n_step_compiles == 1
    assert res.n_launches < res.seq_launches
    assert res.n_rewrites >= res.n_cells


def _as_reference(res, jfleet):
    """An `AtlasResult` of the JAX package holding the port's rows and
    accounting (the tables read no probe)."""
    rows = [jfleet.AtlasRow(**{f.name: getattr(r, f.name)
                               for f in dataclasses.fields(r)})
            for r in res.rows]
    return jfleet.AtlasResult(
        rows=rows, **{k: getattr(res, k) for k in (
            "n_cells", "n_lanes", "n_programs", "n_launches",
            "seq_launches", "n_rewrites", "n_step_compiles", "total_slots",
            "full_slots", "slots_saved", "launch_slots_saved", "dims", "T",
            "chunk", "bucket_dims", "bucket_cells", "bucket_launches",
            "n_requeues")})


def _synthetic_rows(rng):
    """Rows over 3 policies x 3 families x 5 topo_seeds with ratios on a
    0.1 grid, some undecided and re-queued."""
    rows = []
    for pol in ("pi3", "pi3_reg", "pi3bar"):
        for fam in ("ring", "paper_grid", "tree"):
            for ts in (4, 0, 3, 1, 2):
                bound = float(rng.uniform(1, 9))
                ratio = float(rng.integers(0, 11)) / 10
                rows.append(tfleet.AtlasRow(
                    scenario=fam, policy=pol, eps_b=0.05, topo_seed=ts,
                    lam_max=ratio * bound, bound_exact=bound, ratio=ratio,
                    lo=ratio * bound, hi=(ratio + 0.1) * bound,
                    n_calls=int(rng.integers(1, 8)), n_iters=2,
                    undecided=bool(rng.random() < 0.3),
                    hi_certain=None if rng.random() < 0.5 else bound,
                    total_slots=100, full_slots=200, slots_saved=100,
                    probes=(), bucket=int(rng.integers(0, 2)),
                    n_requeues=int(rng.integers(0, 2))))
    return rows


def test_tables_equal_the_reference(tiny, jfleet):
    """`atlas_table` and `policy_surface_table` give the reference's dicts
    on the same rows: a real atlas's and a synthetic policy surface."""
    assert tfleet.atlas_table(tiny) == \
        jfleet.atlas_table(_as_reference(tiny, jfleet))
    surface = dataclasses.replace(
        tiny, rows=_synthetic_rows(np.random.default_rng(5)), n_cells=45,
        bucket_dims=[tfleet.PadDims(15, 14, 3), tfleet.PadDims(16, 24, 4)],
        bucket_cells={0: 20, 1: 25}, bucket_launches={0: 7, 1: 9})
    ref = _as_reference(surface, jfleet)
    assert tfleet.atlas_table(surface) == jfleet.atlas_table(ref)
    assert tfleet.policy_surface_table(surface) == \
        jfleet.policy_surface_table(ref)


@pytest.fixture(scope="module")
def tiny():
    return tfleet.sweep_lambda_max(
        _cells(tfleet, TINY_FAMILIES, eps_b=TINY_EPS), device="cpu",
        **TINY_KW)


def test_buckets_and_requeues_schedule_as_the_reference(tiny, jfleet):
    """At a horizon no verdict latches in, every probe in both packages is
    UNDECIDED, so the two schedulers must agree exactly: buckets, probe
    order, re-queues at a doubled horizon with call_index 1, rewrites,
    launches and slot accounting."""
    res = tiny
    ref = jfleet.sweep_lambda_max(
        _cells(jfleet, TINY_FAMILIES, eps_b=TINY_EPS), **TINY_KW)
    assert res.n_programs == ref.n_programs == 2
    assert res.n_step_compiles == res.n_programs
    for k in ("n_cells", "n_lanes", "n_launches", "seq_launches",
              "n_rewrites", "n_requeues", "total_slots", "full_slots",
              "slots_saved", "launch_slots_saved", "bucket_cells",
              "bucket_launches", "T", "chunk"):
        assert getattr(res, k) == getattr(ref, k), k
    assert [(d.n_nodes, d.n_edges, d.n_comp) for d in res.bucket_dims] == \
        [(d.n_nodes, d.n_edges, d.n_comp) for d in ref.bucket_dims]
    for row, jrow in zip(res.rows, ref.rows):
        assert row.lam_max == jrow.lam_max == 0.0
        assert row.n_requeues == jrow.n_requeues == 1
        assert row.bucket == jrow.bucket
        assert [dataclasses.astuple(p) for p in row.probes] == \
            [dataclasses.astuple(p) for p in jrow.probes]
        assert {p.call_index for p in row.probes} == {0, 1}
        for p in row.probes:
            assert p.slots_run == 2 * (128 << p.call_index)


@pytest.mark.gpu
def test_graphed_chunk_equals_the_eager_chunk_on_the_card():
    """On the card a `GroupLaunch` replays a captured graph.  A second
    launcher from the same start, stepped by the eager `chunk_step`, must
    hold the same carry bit for bit after every chunk, across a rewrite
    that resets two lanes and parks the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    dims = tfleet.PadDims(16, 51, 4)
    jobs = [tfleet.FleetJob(f, "pi3_reg", lam=lam, seed=s, topo_seed=ts,
                            eps_b=0.05)
            for f, lam, s, ts in (("paper_grid", 7.5, 0, 0),
                                  ("ring", 2.5, 1, 1), ("ge_grid", 5.0, 2, 0),
                                  ("fat_tree", 3.0, 3, 2))]
    runner = tengine.make_stream_runner(
        PolicyConfig("pi3_reg", eps_b=0.05), T=2048, chunk=256,
        verdict=tengine.resolve_verdict(None, True))
    inp = _batch(jobs, dims)
    inp = dataclasses.replace(inp, pp=inp.pp.to(dev), **{
        k: getattr(inp, k).to(dev)
        for k in ("lam", "eps_b", "akind", "ekind", "seed", "cdf")})
    graphed, eager = (tengine.GroupLaunch(runner, 4, dims, dev,
                                          inp.arrival_codes, inp.event_codes)
                      for _ in range(2))
    for launch in (graphed, eager):
        launch.start(inp, max_rate=9.0)
    lam = np.array([7.0, 2.0, 5.5, 3.5], np.float32)
    seed = np.array([11, 12, 13, 14], np.int64)
    reset = np.array([True, False, False, True])
    for c in range(4):
        graphed.step()
        runner.chunk_step(eager.inp, eager.carry)
        for a, b in zip(tree_leaves(graphed.carry), tree_leaves(eager.carry)):
            assert torch.equal(a, b), c
        if c == 1:
            for launch in (graphed, eager):
                launch.rewrite(reset, ~reset, lam, seed)
    assert graphed.n_compiles == 1 and graphed.replays == 4 * 4 - 1
    assert eager.graph is None


@pytest.mark.gpu
def test_resume_into_the_captured_graph_on_the_card(tmp_path):
    """On the card a same-process resume (`runtime.resilience`) writes the
    checkpoint's carry into the tensors the killed run's captured graph
    reads and replays it: the fleet and the atlas killed at a boundary
    and resumed equal their uninterrupted runs bit for bit, and nothing
    is captured anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.bp_slot.kernel import slot_step_fused
    from repro_torch.runtime import FaultPlane, Preempted, ResilienceConfig

    def kill_and_resume(run, kill_at, ckpt):
        with pytest.raises(Preempted):
            run(resilience=ResilienceConfig(
                checkpoint_dir=str(ckpt),
                fault_plane=FaultPlane.preempt_after(kill_at)))
        return run(resilience=ResilienceConfig(checkpoint_dir=str(ckpt)))

    jobs = [tfleet.FleetJob(f, "pi3_reg", lam=lam, seed=s, eps_b=0.05)
            for f, lam in (("paper_grid", 4.0), ("ge_grid", 3.0))
            for s in (0, 1)]
    kw = dict(T=512, chunk=128, device="cuda")
    base = tfleet.run_fleet(jobs, **kw)
    captured = slot_step_fused.captured
    res = kill_and_resume(lambda **o: tfleet.run_fleet(jobs, **kw, **o), 2,
                          tmp_path / "fleet")
    assert res.metrics == base.metrics and res.resumed_from == 2
    assert slot_step_fused.captured == captured
    cells = _cells(tfleet, MINI_FAMILIES)
    akw = dict(EXACT_KW, device="cuda")
    abase = tfleet.sweep_lambda_max(cells, **akw)
    captured = slot_step_fused.captured
    ares = kill_and_resume(
        lambda **o: tfleet.sweep_lambda_max(cells, **akw, **o), 3,
        tmp_path / "atlas")
    assert ares.rows == abase.rows and ares.n_launches == abase.n_launches
    assert ares.resumed_from == 3
    assert slot_step_fused.captured == captured
