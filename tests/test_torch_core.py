"""Parity of the port's core numerics (queues, regulator, capacity LP) with
the JAX reference, on the CPU, from numpy inputs with fixed seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import capacity as jcap  # noqa: E402
from repro.core import queues as jq  # noqa: E402
from repro.core.regulator import regulator_push as jreg  # noqa: E402
from repro_torch.core import capacity as tcap  # noqa: E402
from repro_torch.core import queues as tq  # noqa: E402
from repro_torch.core.graph import paper_grid_problem  # noqa: E402
from repro_torch.core.regulator import regulator_push as treg  # noqa: E402
from repro_torch.sim import workload  # noqa: E402


def test_kahan_add_matches_and_compensates():
    rng = np.random.default_rng(0)
    inc = rng.random(3000).astype(np.float32) + np.float32(1e7)
    s = c = np.zeros((), np.float32)
    ts = tc = torch.zeros(())
    for x in inc:
        s, c = jq.kahan_add(jnp.float32(s), jnp.float32(c), jnp.float32(x))
        ts, tc = tq.kahan_add(ts, tc, torch.tensor(x))
        assert float(ts) == float(s) and float(tc) == float(c)
    exact = float(np.sum(inc.astype(np.float64)))
    assert abs(float(ts) - exact) / exact < 1e-7


def test_drift_verdict_update_200_slots_matches_jax():
    """A batch of 5 sims (stable, unstable, in between) through 200 slots
    of the verdict update, against JAX's per-sim update under vmap."""
    B, T = 5, 200
    rng = np.random.default_rng(1)
    lam = np.float32([2.0, 2.0, 5.0, 0.5, 8.0])
    slope = np.float32([0.0, 0.5, 0.02, 0.0, 3.0])
    tqs = (slope[None] * np.arange(T)[:, None]
           + rng.random((T, B)) * 2).astype(np.float32)
    rate = np.where(slope > 0.1, lam * 0.7, lam).astype(np.float32)
    useful = (np.cumsum(rate[None] + rng.normal(0, 0.1, (T, B)), axis=0)
              ).astype(np.float32)
    kw = dict(window=10, burn_in=20, k_stable=3, k_unstable=3,
              drift_tol=0.02, gap_tol=0.05)
    jup = jax.jit(jax.vmap(lambda d, t, q, u, l: jq.drift_verdict_update(
        d, t, q, u, l, **kw)))
    jd = jax.vmap(lambda _: jq.DriftStats.zero())(jnp.arange(B))
    td = tq.DriftStats.zero(B, "cpu")
    for t in range(T):
        tt = np.full(B, t, np.int32)
        jd = jup(jd, tt, tqs[t], useful[t], lam)
        td = tq.drift_verdict_update(td, torch.from_numpy(tt),
                                     torch.from_numpy(tqs[t]),
                                     torch.from_numpy(useful[t]),
                                     torch.from_numpy(lam), **kw)
    for f in ("verdict", "decided_at", "stable_run", "unstable_run"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)
    for f in ("q_mark", "useful_mark", "last_drift", "last_rate"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    names = [tq.VERDICT_NAMES[int(v)] for v in td.verdict]
    assert names[0] == "STABLE" and names[1] == "UNSTABLE"


def test_regulator_with_fed_draws_matches_jax():
    rng = np.random.default_rng(2)
    B, NC = 6, 4
    Y = (rng.random((B, NC)) * 3).astype(np.float32)
    assigned = (rng.random((B, NC)) * 2).astype(np.float32)
    for b in range(B):
        key = jax.random.key(b)
        draws = np.asarray(jax.random.bernoulli(key, 0.3, (NC,)), np.float32)
        want = jreg(jnp.asarray(Y[b]), jnp.asarray(assigned[b]), key, 0.3)
        got = treg(torch.from_numpy(Y[b:b + 1]),
                   torch.from_numpy(assigned[b:b + 1]),
                   torch.from_numpy(draws)[None])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("C,expect", [(2.0, 8.0), (3.0, 10.0)])
def test_copied_lp_gives_paper_capacities(C, expect):
    """C=2 is computation-bound at 8; at C=3 the LP is communication-bound
    at 10 (the paper reads ~9.8 off the simulation knee), as the reference's
    own `tests/test_capacity.py` states."""
    from repro.core.graph import paper_grid_problem as jgrid
    got = tcap.capacity_upper_bound(paper_grid_problem(C=C)).lam_star
    want = jcap.capacity_upper_bound(jgrid(C=C)).lam_star
    assert got == want
    assert got == pytest.approx(expect, abs=1e-6)


def test_counter_stream_is_splitmix64():
    """The int64 torch hash equals SplitMix64 computed in numpy uint64, so
    the stream is the same on every device; uniforms lie in [0, 1)."""
    def mix(z):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))
    g = np.uint64(0x9E3779B97F4A7C15)
    seed = np.array([0, 1, 2**40 + 7], np.uint64)
    t = np.array([0, 5, 123456], np.uint64)
    with np.errstate(over="ignore"):
        base = mix(mix(seed * g + np.uint64(3)) + (t + np.uint64(1)) * g)
        want = mix(base[:, None] + np.arange(1, 5, dtype=np.uint64)[None] * g)
    got = workload.random_bits(torch.tensor(seed.astype(np.int64)),
                               torch.tensor(t.astype(np.int64)), 3, 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    u = workload.uniform(torch.zeros(4096, dtype=torch.long),
                         torch.arange(4096), 1, 8)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_poisson_table_draws_have_poisson_moments():
    lam = [0.5, 3.0, 12.0]
    cdf = workload.poisson_table(lam)
    T = 20000
    u = workload.uniform64(torch.full((T,), 7, dtype=torch.long),
                           torch.arange(T), workload.SITE_ARRIVAL, 1)[:, 0]
    for i, l in enumerate(lam):
        x = workload.poisson_from_uniform(u, cdf[i].expand(T, -1)).numpy()
        assert abs(x.mean() - l) < 4 * np.sqrt(l / T)
        assert abs(x.var() - l) < 0.1 * l
    assert float(1.0 - cdf[-1, -1]) < workload.POISSON_TAIL
