"""The port's fleet slice against the JAX reference, on the CPU.

Batching and scenario constants must equal the reference's; the event and
arrival models, fed the uniforms JAX draws, must make the reference's
moves; whole runs fed the reference's arrival trace and regulator bits
must reach the same verdicts at the same slots with metrics within 1%.
The port's own noise is checked for lane independence, and early stopping
for leaving undecided sims bit-equal.  An AST scan keeps jax and the JAX
package out of the port.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import fleet as jfleet  # noqa: E402
from repro.core.policies import PolicyConfig as JConfig  # noqa: E402
from repro.fleet import scenarios as jscen  # noqa: E402
from repro.sim.simulator import simulate as jsimulate  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.fleet import engine as tengine  # noqa: E402
from repro_torch.fleet import scenarios as tscen  # noqa: E402
from repro_torch.fleet.batching import LEAVES  # noqa: E402
from repro_torch.sim import simulate, sweep_rates  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Batching and scenarios
# ---------------------------------------------------------------------------

def test_scenario_registry_and_codes_match():
    assert tscen.list_scenarios() == jscen.list_scenarios()
    assert tscen.ARRIVAL_MODEL_ORDER == jscen.ARRIVAL_MODEL_ORDER
    assert tscen.EVENT_MODEL_ORDER == jscen.EVENT_MODEL_ORDER
    for name in jscen.list_scenarios():
        j, t = jscen.get_scenario(name), tscen.get_scenario(name)
        assert (j.arrival, j.events, j.wireless) == \
            (t.arrival, t.events, t.wireless)


def test_pad_problem_and_buckets_match_for_every_scenario():
    problems = {}
    for name in jscen.list_scenarios():
        for seed in range(4):
            problems[(name, seed)] = (jfleet.get_scenario(name).build(seed),
                                      tfleet.get_scenario(name).build(seed))
    jdims = jfleet.PadDims.of([p[0] for p in problems.values()])
    tdims = tfleet.PadDims.of([p[1] for p in problems.values()])
    assert (jdims.n_nodes, jdims.n_edges, jdims.n_comp) == \
        (tdims.n_nodes, tdims.n_edges, tdims.n_comp)
    for (jp, tp) in problems.values():
        jpad = jfleet.pad_problem(jp, jdims)
        tpad = tfleet.pad_problem(tp, tdims, "cpu")
        for k in LEAVES:
            np.testing.assert_array_equal(getattr(tpad, k).numpy()[0],
                                          np.asarray(getattr(jpad, k)),
                                          err_msg=k)
    for nb in (1, 3):
        jb, ja = jfleet.make_buckets([p[0] for p in problems.values()], nb)
        tb, ta = tfleet.make_buckets([p[1] for p in problems.values()], nb)
        assert ja == ta
        assert [(d.n_nodes, d.n_edges, d.n_comp) for d in jb] == \
            [(d.n_nodes, d.n_edges, d.n_comp) for d in tb]


def _pp_pair(name, seed=0):
    jp = jfleet.get_scenario(name).build(seed)
    dims = jfleet.PadDims.of([jp])
    tpp = tfleet.pad_problem(tfleet.get_scenario(name).build(seed),
                             tfleet.PadDims(dims.n_nodes, dims.n_edges,
                                            dims.n_comp), "cpu")
    return jfleet.pad_problem(jp, dims), tpp


@pytest.mark.parametrize("model", ["link_flaps", "comp_failures",
                                   "gilbert_elliott", "ge_comp", "ge_full",
                                   "fading", "outage_window", "static"])
def test_event_models_with_fed_uniforms(model):
    """Fed the uniforms the reference draws from its key, every event model
    gives the reference's scales and chain states, slot after slot."""
    jpp, tpp = _pp_pair("paper_grid")
    E, NC = jpp.n_edges, jpp.n_comp
    jmod, tmod = jscen.ModState.init(jpp), tscen.ModState.init(tpp)
    key = jax.random.key(4)
    jfn = jscen.EVENT_MODELS[model]
    for t in (0, 1, 2, 1100, 1101):
        k = jax.random.fold_in(key, t)
        if model == "ge_full":
            k_link, k_comp = jax.random.split(k)
        else:
            k_link = k_comp = k
        u_link = np.asarray(jax.random.uniform(k_link, (E,)))[None]
        u_comp = np.asarray(jax.random.uniform(k_comp, (NC,)))[None]
        jes, jcs, jmod = jfn(jpp, jnp.int32(t), k, jmod)
        tes, tcs, tmod = tscen.EVENT_MODELS[model](
            tpp, torch.tensor([t]), torch.from_numpy(u_link),
            torch.from_numpy(u_comp), tmod)
        np.testing.assert_allclose(tes.numpy()[0], np.asarray(jes),
                                   rtol=1e-6, err_msg="edge scale")
        np.testing.assert_array_equal(tcs.numpy()[0], np.asarray(jcs))
        np.testing.assert_array_equal(tmod.link.numpy()[0],
                                      np.asarray(jmod.link))
        np.testing.assert_array_equal(tmod.comp.numpy()[0],
                                      np.asarray(jmod.comp))


def test_arrival_models_with_fed_uniforms():
    jpp, tpp = _pp_pair("paper_grid")
    lam = np.float32(3.0)
    key = jax.random.key(8)
    # Bernoulli batches: bernoulli(key, p) is uniform(key) < p.
    for t in range(20):
        k = jax.random.fold_in(key, t)
        u = np.asarray(jax.random.uniform(k, (1,)), np.float64)
        want, _ = jscen.ARRIVAL_MODELS["bernoulli_batch"](
            k, jnp.float32(lam), jscen.ModState.init(jpp))
        got, _ = tscen.ARRIVAL_MODELS["bernoulli_batch"](
            torch.tensor([lam]), torch.from_numpy(u), None, None, None)
        assert float(got[0]) == float(want)
    # ON-OFF phase: the flip uniform drives the chain; OFF means no arrivals
    jmod, tmod = jscen.ModState.init(jpp), tscen.ModState.init(tpp)
    cdf = torch.ones((1, 4), dtype=torch.float64)
    for t in range(60):
        k = jax.random.fold_in(key, 100 + t)
        k_flip, _ = jax.random.split(k)
        u_phase = np.asarray(jax.random.uniform(k_flip), np.float32)[None]
        jarr, jmod = jscen.ARRIVAL_MODELS["markov_onoff"](
            k, jnp.float32(lam), jmod)
        tarr, tmod = tscen.ARRIVAL_MODELS["markov_onoff"](
            torch.tensor([lam]), torch.zeros(1, dtype=torch.float64),
            torch.from_numpy(u_phase), cdf, tmod)
        assert float(tmod.burst[0]) == float(jmod.burst)
        if float(jmod.burst) == 0.0:
            assert float(tarr[0]) == float(jarr) == 0.0
    got, _ = tscen.ARRIVAL_MODELS["constant"](torch.tensor([lam]), None,
                                              None, None, None)
    assert float(got[0]) == lam


# ---------------------------------------------------------------------------
# Whole runs against the reference, on the reference's noise
# ---------------------------------------------------------------------------

def _jax_regulator_bits(seed, T, NC, eps):
    """The regulator's draws inside the reference's stream runner:
    bernoulli(split(fold_in(PRNGKey(seed), t), 3)[2], eps, (NC,))."""
    key = jax.random.PRNGKey(seed)

    def bits(t):
        k_step = jax.random.split(jax.random.fold_in(key, t), 3)[2]
        return jax.random.bernoulli(k_step, eps, (NC,))
    return np.asarray(jax.jit(jax.vmap(bits))(jnp.arange(T)), np.float32)


@pytest.mark.parametrize("policy", ["pi3bar", "pi3_reg"])
def test_whole_run_matches_reference(policy):
    T, chunk, eps = 2048, 256, 0.05
    scens, lams, seeds = ("paper_grid", "ring"), (7.2, 2.4), (0, 1)
    rng = np.random.default_rng(21)
    traces = [rng.poisson(lam, T).astype(np.float32) for lam in lams]
    jcfg = JConfig(name=policy, eps_b=eps)
    want = []
    for scen, lam, seed, arr in zip(scens, lams, seeds, traces):
        out = jfleet.stream_simulate(jfleet.get_scenario(scen).build(0),
                                     jcfg, lam, T, chunk=chunk, seed=seed,
                                     arrivals=jnp.asarray(arr))
        want.append({k: float(v) for k, v in out.items()})
    # The port runs both scenarios as one padded batch.
    problems = [tfleet.get_scenario(s).build(0) for s in scens]
    dims = tfleet.PadDims.of(problems)
    pp = tfleet.stack_problems(problems, dims, "cpu")
    reg = np.zeros((2, T, dims.n_comp), np.float32)
    for b, (p, seed) in enumerate(zip(problems, seeds)):
        reg[b, :, :p.n_comp] = _jax_regulator_bits(seed, T, p.n_comp, eps)
    runner = tengine.make_stream_runner(PolicyConfig(name=policy, eps_b=eps),
                                        T, chunk=chunk)
    inp = tengine.make_inputs(pp, lams, [eps, eps], [0, 0], [0, 0], seeds)
    got = runner.run(inp, torch.from_numpy(np.stack(traces)),
                     torch.from_numpy(reg) if policy == "pi3_reg" else None)
    for b in range(2):
        g = {k: float(v[b]) for k, v in got.items()}
        assert g["verdict"] == want[b]["verdict"], scens[b]
        assert g["decided_at_slot"] == want[b]["decided_at_slot"], scens[b]
        for k in ("useful_rate", "mean_queue", "delivered_useful"):
            assert g[k] == pytest.approx(want[b][k], rel=0.01), (scens[b], k)


def test_simulate_tracks_reference_on_fed_arrivals():
    """Key-free pi3bar with a constant arrival trace: the trace simulator's
    cumulative useful deliveries, and the streaming runner's metrics,
    track the reference's."""
    T = 300
    problem_j = jfleet.get_scenario("paper_grid").build(0)
    problem_t = tfleet.get_scenario("paper_grid").build(0)
    arr = np.full(T, 6.0, np.float32)
    want = jsimulate(problem_j, JConfig(name="pi3bar"), 6.0, T,
                     arrivals=jnp.asarray(arr))
    got = simulate(problem_t, PolicyConfig(name="pi3bar"), 6.0, T,
                   arrivals=torch.from_numpy(arr), device="cpu")
    np.testing.assert_allclose(got.delivered_useful.numpy(),
                               np.asarray(want.delivered_useful), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got.n_star.numpy(),
                                  np.asarray(want.n_star))
    jst = jfleet.stream_simulate(problem_j, JConfig(name="pi3bar"), 6.0, T,
                                 chunk=100, arrivals=jnp.asarray(arr))
    tst = tfleet.stream_simulate(problem_t, PolicyConfig(name="pi3bar"), 6.0,
                                 T, chunk=100, arrivals=arr, device="cpu")
    assert set(tst) == set(jst)
    for k in ("delivered_useful", "useful_rate", "mean_queue", "verdict"):
        assert tst[k] == pytest.approx(float(jst[k]), rel=1e-4, abs=1e-3), k
    sw = sweep_rates(problem_t, PolicyConfig(name="pi3bar"), [2.0, 6.0], 64,
                     device="cpu")
    assert sw.total_queue.shape == (2, 64)
    assert float(sw.useful_rate()[0]) < float(sw.useful_rate()[1])


# ---------------------------------------------------------------------------
# The port's own engine: lane independence, early stop, bounds, devices
# ---------------------------------------------------------------------------

def _jobs():
    return [tfleet.FleetJob("paper_grid", "pi3_reg", lam=7.0, seed=3,
                            eps_b=0.05),
            tfleet.FleetJob("ge_comp_grid", "pi3_reg", lam=5.0, seed=1,
                            eps_b=0.05),
            tfleet.FleetJob("bursty_grid", "pi3_reg", lam=6.0, seed=2,
                            eps_b=0.05),
            tfleet.FleetJob("flaky_expander", "pi3", lam=3.0, seed=4,
                            topo_seed=2, eps_b=0.05)]


def test_run_fleet_lanes_are_independent():
    jobs = _jobs()
    dims = tfleet.PadDims(16, 51, 4)
    batch = tfleet.run_fleet(jobs, T=192, chunk=64, device="cpu", dims=dims)
    assert batch.n_programs == 1 and batch.slot_steps == 192
    alone = tfleet.run_fleet(jobs[1:2], T=192, chunk=64, device="cpu",
                             dims=dims)
    assert alone.metrics[0] == batch.metrics[1]
    assert batch.device == "cpu"


def test_early_stop_leaves_undecided_sims_bit_equal():
    """Freezing the decided sim (lam 12, over capacity) must leave the
    undecided one (lam 2, still filling its gradient) bit-equal."""
    v = tfleet.VerdictConfig(window=64, burn_in=256)
    jobs = [tfleet.FleetJob("paper_grid", "pi3bar", lam=lam, seed=s)
            for lam, s in ((2.0, 0), (12.0, 3))]
    kw = dict(T=704, chunk=64, device="cpu", verdict=v)
    full = tfleet.run_fleet(jobs, **kw)
    early = tfleet.run_fleet(jobs, early_stop=True, **kw)
    assert [m["verdict"] for m in early.metrics] == [0.0, 2.0]
    assert early.metrics[0] == full.metrics[0]
    e = early.metrics[1]
    assert e["verdict"] == full.metrics[1]["verdict"]
    assert e["slots_saved"] == 704 - e["decided_at_slot"] > 0
    assert early.slots_saved == e["slots_saved"]


def test_card_scatter_order_changes_only_rounding(monkeypatch):
    """On the card, the plain slot step's `scatter_add` sums each index's
    updates and then adds the base; on the CPU it adds them to the base in
    order.  Emulated here, that order must pass `chip_smoke.py`'s
    teacher-forced card-vs-CPU gate at every slot: non-float leaves equal,
    float leaves within 1e-5 as `carry_diff` scales them."""
    import importlib.util
    from repro_torch.kernels.bp_slot import ref as tref
    from repro_torch.fleet.batching import from_leaves, pad_leaves
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jobs = [tfleet.FleetJob(fam, "pi3_reg", seed=s, topo_seed=ts, eps_b=0.05,
                            lam=frac * tfleet.policy_bound_exact(
                                fam, "pi3_reg", 0.05, topo_seed=ts))
            for fam in ("paper_grid", "ring", "ge_grid", "fat_tree")
            for ts in (0, 1) for frac, s in ((0.95, 0), (1.3, 1))]
    dims = tfleet.PadDims(16, 51, 4)
    pp = from_leaves([pad_leaves(tscen.get_scenario(j.scenario).build(
        j.topo_seed), dims) for j in jobs], dims.n_nodes, dims.n_comp, "cpu")
    inp = tengine.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [tscen.arrival_code(tscen.get_scenario(j.scenario).arrival)
         for j in jobs],
        [tscen.event_code(tscen.get_scenario(j.scenario).events)
         for j in jobs], [j.seed for j in jobs])
    runner = tengine.make_stream_runner(PolicyConfig("pi3_reg", eps_b=0.05),
                                        T=1024, chunk=256)
    in_order = tref.scatter_add

    def summed_first(base, idx, vals):
        return base + in_order(torch.zeros_like(base), idx, vals)

    carry = runner.init_carry(pp)
    for t in range(96):
        monkeypatch.setattr(tref, "scatter_add", summed_first)
        card = runner.slot(inp, carry)
        monkeypatch.setattr(tref, "scatter_add", in_order)
        carry = runner.slot(inp, carry)
        scaled, _, same = smoke.carry_diff(card, carry)
        assert same and max(scaled.values()) <= 1e-5, (t, scaled)
    assert float(carry.state.delivered.min()) > 0


def test_scatter_order_moves_verdicts_only_near_thresholds():
    """The two scatter orders of the plain slot step (the CPU's in-order
    adds, which the fused card kernel follows, and the card's plain path,
    which sums each index's updates first) are rounding of one
    computation, but a routing tie that rounding flips sends the two
    trajectories apart, so a sim whose verdict evaluations pass close to
    a threshold can decide differently.  Pinned on every 16th sim of
    `chip_smoke.main_jobs()` (95 sims, T=1,024, verdict window 128):
    every sim whose evaluations, in both orders, all stay more than 0.02
    (over max(lam, 1)) from the drift and gap thresholds reaches the same
    verdict in both, and such sims are at least a third of the batch.
    The margin: at this size the split sims of three such subsets came at
    most 0.0117 from a threshold (at the main run's T=4,096 and window
    512, 0.0067), while the orders' estimates themselves differed by up
    to 0.40.  `scripts/torch_verdict_rounding.py` runs the full 1,512
    sims (31 split) and compares the split ones with the reference."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_verdict_rounding", ROOT / "scripts" / "torch_verdict_rounding.py")
    vr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vr)
    smoke = vr.load_smoke()
    jobs, _ = smoke.main_jobs()
    jobs = jobs[::16]
    inp = vr.batch_of(jobs, tfleet.PadDims(16, 51, 4))
    runner = tengine.make_stream_runner(
        PolicyConfig("pi3_reg", eps_b=0.05), T=1024, chunk=128,
        verdict=tengine.resolve_verdict(None, True))
    with torch.no_grad():
        cA, cB, margin, _, _, _ = vr.lockstep(runner, inp)
    far = margin > 0.02
    same = cA.drift.verdict == cB.drift.verdict
    assert bool(same[far].all()), [
        (jobs[i].scenario, float(margin[i])) for i in range(len(jobs))
        if far[i] and not same[i]]
    assert int(far.sum()) * 3 >= len(jobs)
    assert vr.tref.scatter_add is vr.IN_ORDER       # the order is restored


def test_bounds_and_sweep_jobs_match_reference():
    spec = {"paper_grid": ["pi3", "pi3_reg"], "ring": ["pi3bar"],
            "fat_tree": ["pi2_reg"]}
    for scen, pols in spec.items():
        for pol in pols:
            for ts in (0, 1):
                assert tfleet.policy_bound_exact(scen, pol, 0.05, ts) == \
                    jfleet.policy_bound_exact(scen, pol, 0.05, ts)
    jj = jfleet.sweep_jobs(spec, [0.5, 0.95], [0, 1], eps_b=0.05)
    tj = tfleet.sweep_jobs(spec, [0.5, 0.95], [0, 1], eps_b=0.05)
    assert [(j.scenario, j.policy, j.lam, j.seed, j.eps_b) for j in jj] == \
        [(j.scenario, j.policy, j.lam, j.seed, j.eps_b) for j in tj]
    assert tfleet.policy_bound(8.0, "pi3_reg", 0.05) == \
        jfleet.policy_bound(8.0, "pi3_reg", 0.05)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = tfleet.get_scenario("paper_grid").build(0)
    cfg = PolicyConfig(name="pi3")
    calls = [
        lambda: tfleet.run_fleet([tfleet.FleetJob("paper_grid")], T=4),
        lambda: tfleet.stream_simulate(problem, cfg, 1.0, T=4),
        lambda: simulate(problem, cfg, 1.0, T=4),
        lambda: sweep_rates(problem, cfg, [1.0], T=4),
        lambda: tfleet.capacity_report({"paper_grid": ["pi3"]}, [0.5], [0],
                                       T=4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_capacity_report_on_cpu():
    table = tfleet.capacity_report({"paper_grid": ["pi3bar"]}, [0.5], [0],
                                   T=128, chunk=64, device="cpu")
    row = table["scenarios"]["paper_grid"]["policies"]["pi3bar"]
    assert row["bound_exact"] == pytest.approx(8.0)
    assert 0.0 < row["efficiency"] <= 1.02
    assert table["device"] == "cpu"


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)
