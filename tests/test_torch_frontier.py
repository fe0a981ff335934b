"""The port's λ_max frontier against the JAX reference, on the CPU.

`fold_seed` and the `Bisection` machine must equal the reference's
exactly; `find_lambda_max` in both packages, with each package's
`run_fleet` replaced by the same stub oracle, must issue the same probes
and reach the same bracket; the seed fold must decouple the port's own
noise streams; and one small real search runs end to end on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.fleet import frontier as jfrontier  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.fleet import frontier as tfrontier  # noqa: E402
from repro_torch.sim import workload  # noqa: E402

#: tests/test_atlas.py::TestBisectionMachine.GRID
GRID = [(s, lo, hi, mc) for s in (0, 1, 2, 3)
        for lo, hi in ((5, 11), (0, 4), (20, 21), (1, 64))
        for mc in (0, 1, 3, 8, 24)]


def _seeded_oracle(seed, p_sus=0.5, p_und=0.3):
    """Deterministic pseudo-random verdict oracle: same k -> same outcome
    (tests/test_atlas.py's)."""
    def oracle(k):
        rng = np.random.default_rng((seed, k))
        sus = bool(rng.random() < p_sus)
        und = bool(not sus and rng.random() < p_und)
        return sus, und
    return oracle


def test_fold_seed_equals_reference():
    coords = [(t, k, c, s) for t in (0, 1, 2, 55, 2 ** 40, -1)
              for k in range(0, 24, 3) for c in (0, 1, 2, 7)
              for s in (0, 1, 2, -3, 2 ** 63 + 5)]
    for x in coords:
        got = tfleet.fold_seed(*x)
        assert got == jfrontier.fold_seed(*x), x
        assert isinstance(got, int) and 0 <= got < 2 ** 31


@pytest.mark.parametrize("seed,k_lo,k_hi,max_calls", GRID)
def test_bisection_matches_reference_probe_for_probe(seed, k_lo, k_hi,
                                                     max_calls):
    """Both machines under the same oracle: the same probe at every pull,
    the same state after every record (`to_state`), the same outcome; and
    a machine serialised mid-search and restored in the other package
    carries on identically."""
    oracle = _seeded_oracle(seed)
    t = tfleet.Bisection(k_lo, k_hi, max_calls=max_calls)
    j = jfrontier.Bisection(k_lo, k_hi, max_calls=max_calls)
    order = []
    for _ in range(4 * max_calls + 200):
        k = t.next_rate_index()
        assert k == j.next_rate_index()
        assert t.to_state() == j.to_state()
        if k is None:
            break
        order.append(k)
        t.record(k, *oracle(k))
        j.record(k, *oracle(k))
        assert t.to_state() == j.to_state()
        if len(order) == 2:            # swap in restored copies mid-search
            t = tfleet.Bisection.from_state(j.to_state())
            j = jfrontier.Bisection.from_state(t.to_state())
    else:
        pytest.fail("Bisection did not terminate")
    assert (t.k_lo, t.k_hi, t.n_iters, t.n_evals, t.done) == \
        (j.k_lo, j.k_hi, j.n_iters, j.n_evals, j.done)
    assert t.undecided_hi == j.undecided_hi
    assert t.k_hi_certain == j.k_hi_certain
    assert t.n_evals == len(order) <= max_calls
    with pytest.raises(ValueError):
        t.record(-1, True)


def _stub_run_fleet(oracle, T, seeds_seen):
    """A `run_fleet` stand-in driven by ``oracle(lam) -> verdict names``;
    the result carries just what `find_lambda_max` reads."""
    def run(jobs, **kw):
        names = oracle(jobs[0].lam)
        seeds_seen.append(tuple(j.seed for j in jobs))
        decided = [T // 2 + 64 * i if v != "UNDECIDED" else T
                   for i, v in enumerate(names)]
        saved = sum(T - d for d in decided)
        metrics = [{"verdict": float(("UNDECIDED", "STABLE",
                                      "UNSTABLE").index(v)),
                    "decided_at_slot": float(d)}
                   for v, d in zip(names, decided)]
        res = dataclasses.make_dataclass("Res", [])()
        res.n_sims, res.T = len(jobs), T
        res.slots_saved, res.launch_slots_saved = saved, 2 * T
        res.n_step_compiles = 1
        res.verdicts = lambda: list(names)
        res.column = lambda name: np.array([m[name] for m in metrics])
        return res
    return run


def _verdict_oracle(lam_star, und_band, n_seeds):
    """STABLE up to ``lam_star``; above it UNSTABLE, except within
    ``und_band`` of it, where the last seed stays UNDECIDED and the others
    STABLE (a probe blocked by horizon-limited evidence)."""
    def oracle(lam):
        if lam <= lam_star:
            return ("STABLE",) * n_seeds
        if lam <= lam_star + und_band:
            return ("STABLE",) * (n_seeds - 1) + ("UNDECIDED",)
        return ("UNSTABLE",) * n_seeds
    return oracle


@pytest.mark.parametrize("lam_star,und_band,bracket,max_calls", [
    (7.8, 0.0, (0.5, 1.1), 24), (7.8, 0.5, (0.5, 1.1), 24),
    (3.0, 2.0, (0.5, 1.1), 24), (12.0, 0.0, (0.5, 1.1), 24),
    (0.5, 0.0, (0.5, 1.1), 24), (7.8, 0.0, (0.2, 0.4), 6),
    (6.1, 1.0, (0.9, 1.0), 3)])
def test_find_lambda_max_equals_reference_under_one_oracle(
        monkeypatch, lam_star, und_band, bracket, max_calls):
    """Each package's `find_lambda_max`, its `run_fleet` replaced by the
    same stub, probes the same rates with the same seeds and reports the
    same bracket and accounting."""
    T, seeds = 1024, (0, 1)
    kw = dict(eps_b=0.05, topo_seed=1, seeds=seeds, T=T, chunk=256,
              rel_tol=0.025, bracket=bracket, max_calls=max_calls)
    oracle = _verdict_oracle(lam_star, und_band, len(seeds))
    seen_t, seen_j = [], []
    monkeypatch.setattr(tfrontier, "run_fleet",
                        _stub_run_fleet(oracle, T, seen_t))
    monkeypatch.setattr(jfrontier, "run_fleet",
                        _stub_run_fleet(oracle, T, seen_j))
    monkeypatch.setattr(jfrontier, "_probe_step_compiles",
                        lambda *a, **k: 1)
    t = tfleet.find_lambda_max("paper_grid", "pi3_reg", device="cpu", **kw)
    j = jfrontier.find_lambda_max("paper_grid", "pi3_reg", **kw)
    assert seen_t == seen_j
    assert [dataclasses.astuple(p) for p in t.probes] == \
        [dataclasses.astuple(p) for p in j.probes]
    for f in ("lam_max", "bound_exact", "ratio", "lo", "hi", "n_calls",
              "n_iters", "undecided", "hi_certain", "total_slots",
              "full_slots", "slots_saved", "launch_slots_saved",
              "n_step_compiles"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.slots_saved_frac == j.slots_saved_frac


def test_fold_seed_decouples_every_axis():
    """tests/test_frontier.py::TestSeedDecoupling, on the port's fold."""
    fold = tfleet.fold_seed
    base = fold(0, 3, 0, 0)
    assert base == fold(0, 3, 0, 0)
    assert base != fold(0, 4, 0, 0)
    assert base != fold(0, 3, 1, 0)
    assert base != fold(1, 3, 0, 0)
    assert base != fold(0, 3, 0, 1)
    seen = {fold(t, k, c, s) for t in range(3) for k in range(12)
            for c in range(2) for s in range(4)}
    assert len(seen) == 3 * 12 * 2 * 4
    assert all(0 <= s < 2 ** 31 for s in seen)


def test_bisection_steps_never_share_arrival_streams():
    """With the raw job seed two probes would draw the same arrivals; with
    the fold, probes at two rates, and a re-probe of one rate, draw
    different streams of the port's noise."""
    T = 256
    same = [workload.poisson_arrivals([5.0], T, seed=0, device="cpu")
            for _ in range(2)]
    assert torch.equal(same[0], same[1])
    s_lo = tfleet.fold_seed(0, rate_index=20, call_index=0, seed=0)
    s_hi = tfleet.fold_seed(0, rate_index=32, call_index=0, seed=0)
    s_again = tfleet.fold_seed(0, rate_index=20, call_index=1, seed=0)
    u, v, w = (workload.poisson_arrivals([5.0], T, seed=s, device="cpu")
               for s in (s_lo, s_hi, s_again))
    assert not torch.equal(u, v)
    assert not torch.equal(u, w)


def test_small_real_search_on_the_cpu():
    """paper_grid end to end on the CPU at a short horizon: the probes lie
    on the grid and follow the machine, the accounting adds up, and the
    search made one chunk launcher."""
    kw = dict(eps_b=0.05, seeds=(0, 1), T=1024, chunk=128, rel_tol=0.25,
              max_calls=3, verdict=tfleet.VerdictConfig(window=128,
                                                        burn_in=512))
    r = tfleet.find_lambda_max("paper_grid", "pi3", device="cpu", **kw)
    step = 0.25 * r.bound_exact
    assert r.bound_exact == pytest.approx(8.0)
    assert r.n_calls == len(r.probes) <= 3
    assert r.n_step_compiles == 1
    bis = tfleet.Bisection(2, 5, max_calls=3)
    for p in r.probes:
        assert p.rate_index == bis.next_rate_index()
        assert p.lam == p.rate_index * step and p.call_index == 0
        assert len(p.verdicts) == len(p.decided_at) == 2
        assert p.slots_run + p.slots_saved == 2 * 1024
        assert p.sustainable == all(v == "STABLE" for v in p.verdicts)
        bis.record(p.rate_index, p.sustainable, p.undecided)
    assert bis.next_rate_index() is None
    assert (r.lo, r.hi) == (bis.k_lo * step, bis.k_hi * step)
    assert r.lam_max == r.lo <= r.bound_exact
    assert r.full_slots == 2 * 1024 * r.n_calls
    assert r.slots_saved == r.full_slots - r.total_slots


def test_frontier_and_atlas_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tfleet.find_lambda_max("paper_grid", T=4),
        lambda: tfleet.sweep_lambda_max([tfleet.AtlasJob("paper_grid")],
                                        T=4),
        lambda: tfleet.sweep_policy_surface(["paper_grid"], [0], T=4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
