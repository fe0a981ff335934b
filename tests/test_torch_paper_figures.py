"""The port's trace simulator, arrival laws, the slot's two phases and the
paper-figure suites against the JAX reference, on the CPU.

The trace runner is fed the reference's own noise: its Poisson arrivals
and the regulator bits its scan draws, bernoulli(split(key, T)[t], eps_B,
(NC,)).  Decisions (n*) must be equal; traces within rtol 1e-4 / atol
1e-3.  One slot and the two phases are held from a random state made with
numpy.  The suites of `scripts/torch_paper_figures.py` run at a cut
horizon and are checked for their rows; their claims are asserted at the
paper's horizon on the card.  A walk over the reference's subpackages
asserts the port exports every public name.
"""
import importlib
import importlib.util
import pathlib
import pkgutil
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core import PolicyConfig as JConfig  # noqa: E402
from repro.core import StaticProblem as JStatic  # noqa: E402
from repro.core import paper_grid_problem as jgrid  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core.queues import NetState as JState  # noqa: E402
from repro.sim import simulator as jsim  # noqa: E402
from repro.sim import workload as jwork  # noqa: E402
from repro_torch.convert import (STATE_FIELDS, net_state_from_numpy,  # noqa: E402
                                 net_state_to_numpy)
from repro_torch.core import (PolicyConfig, bp_route_slot,  # noqa: E402
                              computation_slot, paper_grid_problem)
from repro_torch.fleet import scenarios as tscen  # noqa: E402
from repro_torch.fleet.batching import LEAVES  # noqa: E402
from repro_torch.sim import (bernoulli_batch_arrivals, build_step,  # noqa: E402
                             constant_arrivals, make_step, make_trace_runner,
                             workload)
from test_torch_bp_slot import random_state  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPS = 0.05
T_PARITY = 256


def _reference_noise(lam, T, NC, seed):
    """The reference's arrivals and the regulator bits its scan draws."""
    akey, skey = jax.random.split(jax.random.key(seed))
    arr = np.asarray(jwork.poisson_arrivals(akey, lam, T), np.float32)
    bits = jax.vmap(lambda k: jax.random.bernoulli(k, EPS, (NC,)))(
        jax.random.split(skey, T))
    return arr, skey, np.asarray(bits, np.float32)


@pytest.mark.parametrize("C,policy,lams", [
    (2.0, "pi3", (6.0, 9.0)), (2.0, "pi3bar", (6.0, 9.0)),
    (3.0, "pi3", (8.0, 10.5)), (3.0, "pi3bar", (8.0, 10.5))])
def test_trace_runner_matches_reference_on_its_noise(C, policy, lams):
    """Two rates as one batch of the port's runner, each against the
    reference's `make_trace_runner` on the same arrivals and bits."""
    jp = jgrid(C=C)
    jrun = jsim.make_trace_runner(JStatic.build(jp), JConfig(name=policy,
                                                             eps_b=EPS))
    NC = jp.n_comp
    noise = [_reference_noise(lam, T_PARITY, NC, seed)
             for seed, lam in enumerate(lams)]
    want = [jrun(jnp.asarray(arr), skey) for arr, skey, _ in noise]
    pp, _ = build_step(paper_grid_problem(C=C), PolicyConfig(name=policy,
                                                             eps_b=EPS),
                       "cpu")
    run = make_trace_runner(pp, PolicyConfig(name=policy, eps_b=EPS))
    got = run(torch.from_numpy(np.stack([n[0] for n in noise])),
              torch.from_numpy(np.stack([n[2] for n in noise])))
    assert got.total_queue.shape == (len(lams), T_PARITY)
    for b, w in enumerate(want):
        np.testing.assert_array_equal(got.n_star[b].numpy(),
                                      np.asarray(w.n_star))
        for k in ("total_queue", "delivered", "delivered_useful",
                  "computed"):
            np.testing.assert_allclose(getattr(got, k)[b].numpy(),
                                       np.asarray(getattr(w, k)),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
        for k in STATE_FIELDS:
            np.testing.assert_allclose(
                getattr(got.final_state, k)[b].numpy(),
                np.asarray(getattr(w.final_state, k)), rtol=1e-4, atol=1e-3,
                err_msg=k)


def test_seeded_runner_equals_fed_bits_of_its_own_stream():
    """``run(arrivals, seed)`` draws the regulator's bits of the port's
    stream; fed those bits, the runner gives the same traces bit for bit,
    and an unregulated policy ignores the noise."""
    pp, _ = build_step(paper_grid_problem(C=2.0), PolicyConfig(), "cpu")
    arr = workload.poisson_arrivals([5.0, 7.5], 96, seed=4, device="cpu")
    t = torch.arange(96).repeat(2, 1).reshape(-1)
    bits = workload.regulator_bits(torch.full_like(t, 4), t,
                                   torch.full((t.shape[0],), 0.01), 4)
    run = make_trace_runner(pp, PolicyConfig(name="pi3"))
    a, b = run(arr, 4), run(arr, bits.reshape(2, 96, 4))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    bar = make_trace_runner(pp, PolicyConfig(name="pi3bar"))
    for x, y in zip(bar(arr, 0)[1:], bar(arr, 9)[1:]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="B, T"):
        run(arr[0], 4)


def test_make_step_one_slot_matches_reference():
    jp = jgrid(C=2.0)
    sp = JStatic.build(jp)
    rng = np.random.default_rng(3)
    state0 = random_state(rng, jp.graph.n_nodes, jp.n_comp)
    key = jax.random.key(5)
    bits = np.asarray(jax.random.bernoulli(key, EPS, (jp.n_comp,)),
                      np.float32)
    jstate, jout = jsim.make_step(sp, JConfig(name="pi3", eps_b=EPS))(
        JState(**{k: jnp.asarray(v) for k, v in state0.items()}),
        (jnp.float32(4.0), key))
    cfg = PolicyConfig(name="pi3", eps_b=EPS)
    pp, _ = build_step(paper_grid_problem(C=2.0), cfg, "cpu")
    tstate, tout = make_step(pp, cfg)(net_state_from_numpy(state0, "cpu"),
                        (torch.tensor([4.0]), torch.from_numpy(bits)[None]))
    assert int(tout[4][0]) == int(jout[4]) and tout[4].dtype == torch.int32
    for g, w in zip(tout[:4], jout[:4]):
        assert float(g[0]) == pytest.approx(float(w), rel=1e-6, abs=1e-6)
    got = net_state_to_numpy(tstate)
    for k in STATE_FIELDS:
        np.testing.assert_allclose(got[k][0], np.asarray(getattr(jstate, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_build_step_problem_is_the_static_problem():
    sp = JStatic.build(jgrid(C=3.0))
    pp, _ = build_step(paper_grid_problem(C=3.0), PolicyConfig(), "cpu")
    assert (pp.batch, pp.n_nodes, pp.n_comp, pp.n_edges) == \
        (1, sp.n_nodes, sp.n_comp, sp.edges.shape[0])
    for k in ("edges", "edge_cap", "comp_nodes", "comp_caps", "sink"):
        np.testing.assert_array_equal(getattr(pp, k)[0].numpy(),
                                      np.asarray(getattr(sp, k)), err_msg=k)
    for k in ("s1", "s2", "dest"):
        assert int(getattr(pp, k)[0]) == getattr(sp, k)
    assert bool((pp.edge_mask == 1).all()) and bool((pp.comp_mask == 1).all())


def test_bernoulli_batch_arrivals_law_and_bits():
    """Bursts of 4 at mean rate lam (the reference's law: its draws are
    threefry's, so their mean, not their bits, is compared), and the very
    counts a fleet lane under `bernoulli_batch` draws with the seed."""
    T, lams = 20_000, [1.0, 2.0, 6.0]
    got = bernoulli_batch_arrivals(lams, T, seed=3, device="cpu")
    assert got.shape == (3, T) and got.dtype == torch.float32
    key = jax.random.key(3)
    for lam, row in zip(lams, got.numpy()):
        want = np.asarray(jwork.bernoulli_batch_arrivals(key, lam, T))
        assert set(np.unique(row)) <= {0.0, 4.0}
        assert set(np.unique(want)) <= {0.0, 4.0}
        mean = min(lam, 4.0)
        assert row.mean() == pytest.approx(mean, abs=0.06)
        assert want.mean() == pytest.approx(mean, abs=0.06)
    t = torch.arange(T)
    u = workload.uniform64(torch.full((T,), 3), t, workload.SITE_ARRIVAL,
                           1)[:, 0]
    lane, _ = tscen.ARRIVAL_MODELS["bernoulli_batch"](
        torch.full((T,), 2.0), u, None, None, None)
    assert torch.equal(lane, got[1])
    one = bernoulli_batch_arrivals(2.0, 64, seed=3, device="cpu")
    assert one.shape == (64,) and torch.equal(one, got[1, :64])
    g1, g2 = (torch.Generator().manual_seed(8) for _ in range(2))
    assert torch.equal(bernoulli_batch_arrivals(2.0, 64, g1, "cpu"),
                       bernoulli_batch_arrivals(2.0, 64, g2, "cpu"))


def test_constant_arrivals_values():
    got = constant_arrivals(2.5, 7, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jwork.constant_arrivals(2.5, 7)))
    both = constant_arrivals([1.0, 3.25], 5, device="cpu")
    assert both.shape == (2, 5) and both.dtype == torch.float32
    np.testing.assert_array_equal(both[1].numpy(), np.full(5, 3.25,
                                                           np.float32))


def _phase_inputs(seed):
    jp = jgrid(C=2.0)
    rng = np.random.default_rng(seed)
    states = [random_state(rng, jp.graph.n_nodes, jp.n_comp)
              for _ in range(2)]
    batched = {k: np.stack([s[k] for s in states]) for k in STATE_FIELDS}
    pp, _ = build_step(paper_grid_problem(C=2.0), PolicyConfig(), "cpu")
    pp = pp.replace(**{k: getattr(pp, k).expand(2, *getattr(pp, k).shape[
        1:]).contiguous() for k in LEAVES})
    return (JStatic.build(jp), pp, states,
            net_state_from_numpy(batched, "cpu"))


def _assert_states(got, want, b):
    g = net_state_to_numpy(got)
    for k in STATE_FIELDS:
        np.testing.assert_allclose(g[k][b], np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("wireless", [False, True])
def test_bp_route_slot_matches_reference(wireless):
    sp, pp, states, ts = _phase_inputs(11)
    got, gm = bp_route_slot(pp, ts, wireless=wireless)
    for b, s in enumerate(states):
        want, wm = jpol.bp_route_slot(sp, JState(**{
            k: jnp.asarray(v) for k, v in s.items()}), wireless=wireless)
        _assert_states(got, want, b)
        assert float(gm["routed"][b]) == pytest.approx(float(wm["routed"]),
                                                       rel=1e-6)


@pytest.mark.parametrize("policy", ["pi3", "pi3bar", "pi1"])
def test_computation_slot_matches_reference(policy):
    sp, pp, states, ts = _phase_inputs(12)
    rng = np.random.default_rng(2)
    assigned = (rng.random((2, sp.n_comp)) * 3).astype(np.float32)
    keys = [jax.random.key(20 + b) for b in range(2)]
    bits = np.stack([np.asarray(jax.random.bernoulli(k, EPS, (sp.n_comp,)),
                                np.float32) for k in keys])
    cfg = PolicyConfig(name=policy, eps_b=EPS)
    got, gm = computation_slot(pp, cfg, ts, torch.from_numpy(assigned),
                               torch.from_numpy(bits))
    for b, s in enumerate(states):
        want, wm = jpol.computation_slot(
            sp, JConfig(name=policy, eps_b=EPS),
            JState(**{k: jnp.asarray(v) for k, v in s.items()}),
            jnp.asarray(assigned[b]), keys[b])
        _assert_states(got, want, b)
        assert float(gm["computed"][b]) == pytest.approx(
            float(wm["computed"]), rel=1e-6)
    if cfg.use_regulator:
        with pytest.raises(ValueError, match="regulator"):
            computation_slot(pp, cfg, ts, torch.from_numpy(assigned))


# ---------------------------------------------------------------------------
# The suites of scripts/torch_paper_figures.py at a cut horizon
# ---------------------------------------------------------------------------

def _figures():
    spec = importlib.util.spec_from_file_location(
        "torch_paper_figures", ROOT / "scripts" / "torch_paper_figures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expected_rows(mod, suite: str, T: int) -> list:
    if suite == "fig5b":
        return [f"fig5b/C{C:g}/{name}/lam{lam:g}" for C in (2.0, 3.0)
                for name in ("pi3", "pi3bar") for lam in mod.LAMS[C]]
    if suite == "fig5c":
        return ([f"fig5c/run_avg_computations/t{T * m // mod.FIG5C_T}"
                 for m in mod.FIG5C_MARKS] +
                [f"fig5c/embedding_share/node{i}" for i in range(4)])
    return ([f"capacity/C{C}/{k}" for C in (2, 3)
             for k in ("LP", "sim_saturation")] +
            [f"capacity/C2/single_node{i}" for i in range(4)] +
            ["capacity/C2/two_identical_streams"] +
            [f"capacity/C2/pairing_{p}" for p in ("fifo", "bound")])


FIELD = re.compile(r"^[a-z_]+=-?\d+(\.\d+)?$")


@pytest.mark.parametrize("suite,claims", [
    ("fig5b", {"C2/pi3/knee", "C2/pi3bar/knee", "C3/pi3/knee",
               "C3/pi3bar/knee"}),
    ("fig5c", {"converges"}),
    ("table_capacity", {"C2/sat_below_bound", "C2/sat_near_bound",
                        "C3/sat_below_bound", "C3/sat_near_bound",
                        "two_streams_total_8"})])
def test_suite_rows_at_a_cut_horizon(suite, claims):
    mod = _figures()
    T = 400
    lines = []
    out = mod.SUITES[suite](lines.append, "cpu", T)
    rows = [ln for ln in lines if not ln.startswith("#")]
    assert [r.split(",")[0] for r in rows] == _expected_rows(mod, suite, T)
    for r in rows:
        name, us, derived = r.split(",")
        assert us == "" or float(us) > 0, r
        for field in derived.split(";"):
            assert FIELD.match(field), r
    assert set(out["checks"]) == claims
    assert all(isinstance(v, bool) for v in out["checks"].values())
    if suite == "fig5b":
        assert out["lam_star"] == {2.0: pytest.approx(8.0),
                                   3.0: pytest.approx(10.0)}
    if suite == "table_capacity":
        assert out["checks"]["two_streams_total_8"]
        assert [out[("single_node", i)] for i in range(4)] == \
            [pytest.approx(2.0)] * 4


# ---------------------------------------------------------------------------
# Public names
# ---------------------------------------------------------------------------

def test_port_exports_every_public_name_of_the_reference():
    """Each subpackage of `repro` with an ``__all__`` has a counterpart in
    `repro_torch` that has each of those names."""
    walked = []
    for info in pkgutil.walk_packages(repro.__path__, "repro."):
        if not info.ispkg:
            continue
        names = getattr(importlib.import_module(info.name), "__all__", None)
        if names is None:
            continue
        port = importlib.import_module("repro_torch" +
                                       info.name[len("repro"):])
        missing = [n for n in names if not hasattr(port, n)]
        assert not missing, (info.name, missing)
        walked.append(info.name)
    assert {"repro.core", "repro.sim", "repro.fleet", "repro.serving"} <= \
        set(walked)
