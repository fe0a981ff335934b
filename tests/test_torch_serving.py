"""The port's serving slice against the JAX reference, on the CPU.

The latency accumulator and the admission gate must be bit-exact against
the reference on the same float32 inputs; the trace's draws, fed the
uniforms JAX draws, must make the reference's moves; a whole serving run
fed the reference's class arrivals and regulator bits must reach its
metrics within 1e-5 relative with the same verdict, gate and flips.  The
port's own behaviour is held to the reference's assertions
(`tests/test_serving.py`: TestTrace, TestLatency, TestAdmission, the
chunked-equals-closed check, overload fairness, the outage loop).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro import serving as js  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.policies import PolicyConfig as JConfig  # noqa: E402
from repro.core.queues import DriftStats as JDrift  # noqa: E402
from repro.fleet import PadDims as JDims, get_scenario as jscenario  # noqa: E402
from repro.fleet import pad_problem as jpad, policy_bound_exact  # noqa: E402
from repro.fleet.scenarios import ModState as JMod, event_code  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.core.queues import DriftStats  # noqa: E402
from repro_torch.fleet.scenarios import ModState  # noqa: E402
from repro_torch.serving import trace as ttrace  # noqa: E402
from repro_torch.sim import workload  # noqa: E402

EPS = 0.05


def _pp(scenario="paper_grid", B=1, topo_seed=0):
    p = tfleet.get_scenario(scenario).build(topo_seed)
    return tfleet.stack_problems([p] * B, tfleet.PadDims.of([p]), "cpu")


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

class TestTrace:
    def test_registry_equals_the_references(self):
        assert ts.list_traces() == js.list_traces()
        for name in js.list_traces():
            j, t = js.get_trace(name), ts.get_trace(name)
            assert (j.diurnal_period, j.diurnal_depth) == \
                (t.diurnal_period, t.diurnal_depth)
            assert [(c.name, c.arrival, c.frac) for c in j.classes] == \
                [(c.name, c.arrival, c.frac) for c in t.classes]
        with pytest.raises(KeyError, match="unknown trace"):
            ts.get_trace("nope")

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="sum to 1"):
            ts.TraceSpec("bad", (ts.QueryClass("a", "poisson", 0.5),))
        with pytest.raises(ValueError, match="unknown arrival"):
            ts.QueryClass("a", "zipf")
        with pytest.raises(ValueError, match="at least one"):
            ts.TraceSpec("empty", ())
        with pytest.raises(ValueError, match="diurnal_depth"):
            ts.TraceSpec("deep", (ts.QueryClass("a"),), diurnal_period=10,
                         diurnal_depth=1.5)

    def test_envelope_mean_one_and_equal_to_the_references(self):
        spec = ts.get_trace("diurnal_mix")
        t = torch.arange(spec.diurnal_period)
        env = ttrace.envelope(spec, t)
        assert float(env.mean()) == pytest.approx(1.0, abs=1e-3)
        assert float(env.max()) == pytest.approx(1 + spec.diurnal_depth,
                                                 abs=1e-3)
        want = jax.vmap(lambda ti: js.trace.envelope(
            js.get_trace("diurnal_mix"), ti))(jnp.arange(2000))
        np.testing.assert_allclose(env.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        assert ttrace.envelope(ts.get_trace("steady"), torch.tensor([7])) \
            == 1.0

    def _trace(self, spec, lam, T, seed=0, B=1):
        """[B, T, K] arrivals of the port's own noise, slot by slot."""
        pp = _pp(B=B)
        lam_t = torch.full((B,), lam, dtype=torch.float32)
        seeds = torch.arange(seed, seed + B, dtype=torch.long)
        cdf = ttrace.class_table(spec, lam_t.numpy(), "cpu")
        tr, mod = ts.TraceState.init(spec, B, "cpu"), ModState.init(pp)
        out = []
        for t in range(T):
            tt = torch.full((B,), t, dtype=torch.int32)
            u, u_phase = ttrace.class_noise(spec, seeds, tt)
            a, tr = ts.draw_arrivals(spec, lam_t, tt, tr, mod, u, u_phase,
                                     cdf)
            out.append(a)
        return torch.stack(out, 1).numpy()

    def test_mixture_rates_and_determinism(self):
        spec = ts.get_trace("bursty_mix")
        lam, T = 4.0, 4000
        arrs = self._trace(spec, lam, T)[0]
        assert arrs.shape == (T, 2)
        np.testing.assert_allclose(arrs.mean(0), [2.0, 2.0], rtol=0.1)
        assert arrs.sum(1).mean() == pytest.approx(lam, rel=0.07)
        np.testing.assert_array_equal(arrs, self._trace(spec, lam, T)[0])

    def test_markov_classes_burst_independently(self):
        spec = ts.TraceSpec("two_bursts",
                            (ts.QueryClass("a", "markov_onoff", 0.5),
                             ts.QueryClass("b", "markov_onoff", 0.5)))
        arrs = self._trace(spec, 4.0, 2000)[0]
        off_a, off_b = arrs[:, 0] == 0.0, arrs[:, 1] == 0.0
        assert 0.1 < off_a.mean() < 0.9 and 0.1 < off_b.mean() < 0.9
        assert (off_a != off_b).mean() > 0.05

    def test_diurnal_rate_follows_the_envelope(self):
        """The in-slot CDF of the enveloped trace: the long-run rate is
        lam, and the peak half-period carries more than the trough's."""
        spec = ts.get_trace("diurnal_mix")
        arrs = self._trace(spec, 4.0, 2000, B=4).sum(-1)     # [B, T]
        assert arrs.mean() == pytest.approx(4.0, rel=0.05)
        assert arrs[:, :1000].mean() > 1.2 * arrs[:, 1000:].mean()

    def test_draw_chain_fed_jax_uniforms_equals_the_references(self):
        """An ON-OFF class and a Bernoulli-batch class, fed the uniforms
        JAX draws from each slot's keys: the same phases slot after slot,
        the same batch arrivals, and no ON-OFF arrival while OFF."""
        spec_j = js.TraceSpec("onoff_batch",
                              (js.QueryClass("a", "markov_onoff", 0.5),
                               js.QueryClass("b", "bernoulli_batch", 0.5)))
        spec_t = ts.TraceSpec("onoff_batch",
                              (ts.QueryClass("a", "markov_onoff", 0.5),
                               ts.QueryClass("b", "bernoulli_batch", 0.5)))
        jp = jscenario("paper_grid").build(0)
        jpp = jpad(jp, JDims.of([jp]))
        jtr, jmod = js.TraceState.init(spec_j), JMod.init(jpp)
        pp = _pp()
        ttr, tmod = ts.TraceState.init(spec_t, 1, "cpu"), ModState.init(pp)
        lam = np.float32(5.0)
        cdf = ttrace.class_table(spec_t, [lam], "cpu")
        key = jax.random.key(11)
        seen_off = 0
        for t in range(200):
            k = jax.random.fold_in(key, t)
            keys = jax.random.split(k, 2)
            k_flip, _ = jax.random.split(keys[0])
            u_phase = np.array([[float(jax.random.uniform(k_flip)), 0.0]],
                               np.float32)
            u = np.array([[0.0, float(jax.random.uniform(keys[1], (1,))[0])]])
            jarr, jtr = js.draw_arrivals(spec_j, k, jnp.float32(lam),
                                         jnp.int32(t), jtr, jmod)
            tarr, ttr = ts.draw_arrivals(
                spec_t, torch.tensor([lam]), torch.tensor([t]), ttr, tmod,
                torch.from_numpy(u), torch.from_numpy(u_phase), cdf)
            np.testing.assert_array_equal(ttr.burst.numpy()[0],
                                          np.asarray(jtr.burst))
            assert float(tarr[0, 1]) == float(jarr[1])
            if float(jtr.burst[0]) == 0.0:
                seen_off += 1
                assert float(tarr[0, 0]) == float(jarr[0]) == 0.0
        assert seen_off > 10

    def test_class_tables_and_in_slot_cdf_are_poisson(self):
        """A fixed-rate class's row and the in-slot CDF at the same rate
        are scipy's Poisson CDF (the ON-OFF class at lam / P(ON)); rows
        beyond their own width and non-Poisson classes read 1.0."""
        spec = ts.get_trace("bursty_mix")
        lam = np.array([4.0, 10.4], np.float32)
        cdf = ttrace.class_table(spec, lam, "cpu").numpy()
        W = cdf.shape[-1]
        assert W == workload.poisson_width(
            float(np.float32(10.4) * np.float32(0.5)) / ttrace.MMPP_PI_ON)
        k = np.arange(W)
        for b in range(2):
            rate_on = float(lam[b] * np.float32(0.5)) / ttrace.MMPP_PI_ON
            rate = float(lam[b] * np.float32(0.5))
            for col, r in ((0, rate_on), (1, rate)):
                own = workload.poisson_width(r)
                np.testing.assert_allclose(cdf[b, col, :own],
                                           stats.poisson.cdf(k[:own], r),
                                           rtol=0, atol=1e-14)
                assert (cdf[b, col, own:] == 1.0).all()
        got = ttrace.poisson_cdf(torch.tensor([3.0, 0.0, 12.5]), 48).numpy()
        np.testing.assert_allclose(got[0, :-1], stats.poisson.cdf(
            np.arange(47), 3.0), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[2, :-1], stats.poisson.cdf(
            np.arange(47), 12.5), rtol=0, atol=1e-12)
        assert (got[:, -1] == 1.0).all() and (got[1] == 1.0).all()
        env = ttrace.class_table(ts.get_trace("diurnal_mix"), lam, "cpu")
        assert (env == 1.0).all() and env.shape[-1] == \
            workload.poisson_width(float(lam.max() * np.float32(0.6)) * 1.3)


# ---------------------------------------------------------------------------
# latency accumulators
# ---------------------------------------------------------------------------

class TestLatency:
    HORIZON, BINS = 64, 32          # bin width 2 slots

    def _run(self, T, delay, rate=1.0):
        """Admit `rate`/slot; deliver the same fluid `delay` slots later."""
        lat = tlat.LatencyStats.zero(1, self.HORIZON, self.BINS, "cpu")
        for t in range(T):
            adm = rate * (t + 1)
            dlv = rate * max(t + 1 - delay, 0)
            out = rate if t >= delay else 0.0
            lat = tlat.latency_update(
                lat, torch.tensor([t]), torch.tensor([adm]),
                torch.tensor([dlv]), torch.tensor([out]),
                horizon=self.HORIZON, n_bins=self.BINS)
        return lat

    def test_constant_lag_measures_exact_delay(self):
        d = 6
        lat = self._run(40, d)
        assert float(tlat.latency_mean(lat)[0]) == pytest.approx(d)
        p50, p99 = tlat.latency_quantiles(
            lat.hist, (0.5, 0.99), horizon=self.HORIZON,
            n_bins=self.BINS)[0].numpy()
        assert d <= p50 <= d + 2 and d <= p99 <= d + 2

    def test_empty_histogram_reports_zero(self):
        lat = tlat.LatencyStats.zero(1, self.HORIZON, self.BINS, "cpu")
        q = tlat.latency_quantiles(lat.hist, (0.5, 0.99),
                                   horizon=self.HORIZON, n_bins=self.BINS)
        assert float(tlat.latency_mean(lat)[0]) == 0.0
        np.testing.assert_array_equal(q.numpy()[0], [0.0, 0.0])

    def test_delay_caps_at_horizon_in_overflow_bin(self):
        lat = tlat.LatencyStats.zero(1, self.HORIZON, self.BINS, "cpu")
        for t in range(self.HORIZON + 8):
            lat = tlat.latency_update(
                lat, torch.tensor([t]), torch.tensor([t + 1.0]),
                torch.tensor([0.0]), torch.tensor([1.0]),
                horizon=self.HORIZON, n_bins=self.BINS)
        assert float(lat.hist[0, -1]) > 0
        q = tlat.latency_quantiles(lat.hist, (0.99,), horizon=self.HORIZON,
                                   n_bins=self.BINS)
        assert float(q[0, 0]) == self.HORIZON

    def test_bit_exact_against_the_reference(self):
        """Four sims, each its own random fluid trajectory (admitted and
        delivered curves with random lag and noise), through both
        accumulators slot by slot: ring, histogram, delay sum and its
        compensation bit-equal every slot; the quantiles bit-equal.  The
        mean divides by the histogram's sum, which XLA's CPU reduction and
        torch's add in different orders: within 2 ulp here, and bit-equal
        where every order sums exactly (`test_reductions_bit_exact_...`)."""
        rng = np.random.default_rng(5)
        B, T, H, NB = 4, 300, 64, 32
        inc = rng.gamma(2.0, 1.5, (B, T)).astype(np.float32)
        adm = np.cumsum(inc, 1, dtype=np.float32)
        lag = rng.integers(0, 80, B)
        dlv = np.stack([np.concatenate([np.zeros(l, np.float32),
                                        adm[b, :T - l]])
                        for b, l in enumerate(lag)])
        dlv = np.maximum.accumulate(dlv * rng.uniform(0.9, 1.0, (B, T)),
                                    axis=1).astype(np.float32)
        out = np.diff(dlv, axis=1, prepend=0.0).astype(np.float32)
        t_lat = tlat.LatencyStats.zero(B, H, NB, "cpu")
        j_lat = [jlat.LatencyStats.zero(H, NB) for _ in range(B)]
        upd = jax.jit(jlat.latency_update, static_argnames=("horizon",
                                                            "n_bins"))
        offs = rng.integers(0, 5, B)          # sims at different slots
        for t in range(T):
            tt = torch.from_numpy((t + offs).astype(np.int32))
            t_lat = tlat.latency_update(
                t_lat, tt, torch.from_numpy(adm[:, t]),
                torch.from_numpy(dlv[:, t]), torch.from_numpy(out[:, t]),
                horizon=H, n_bins=NB)
            for b in range(B):
                j_lat[b] = upd(j_lat[b], jnp.int32(t + offs[b]),
                               adm[b, t], dlv[b, t], out[b, t],
                               horizon=H, n_bins=NB)
            if t % 50 == 49 or t == T - 1:
                for b in range(B):
                    for name in ("ring", "hist", "sum_delay", "c_delay"):
                        np.testing.assert_array_equal(
                            getattr(t_lat, name).numpy()[b],
                            np.asarray(getattr(j_lat[b], name)),
                            err_msg=f"{name} sim {b} slot {t}")
        qs = (0.5, 0.9, 0.99)
        got_q = tlat.latency_quantiles(t_lat.hist, qs, horizon=H,
                                       n_bins=NB).numpy()
        got_m = tlat.latency_mean(t_lat).numpy()
        for b in range(B):
            np.testing.assert_array_equal(got_q[b], np.asarray(
                jlat.latency_quantiles(j_lat[b].hist, qs, horizon=H,
                                       n_bins=NB)))
            np.testing.assert_allclose(got_m[b], float(
                jlat.latency_mean(j_lat[b])), rtol=2.0 ** -22, atol=0)
        assert (got_m > 0).all() and (t_lat.hist[:, -1] > 0).any()

    def test_reductions_bit_exact_on_exactly_summable_histograms(self):
        """Histograms of multiples of 1/64 below 2^10 sum exactly in any
        order: there the quantiles and the mean are bit-equal to the
        reference's, including empty rows and a delay sum with a
        compensation term."""
        rng = np.random.default_rng(9)
        H, NB = 1024, 128
        hist = (rng.integers(0, 4096, (6, NB + 1)) / 64.0
                ).astype(np.float32)
        hist[rng.random((6, NB + 1)) < 0.6] = 0.0
        hist[2] = 0.0
        sd = rng.uniform(0, 1e6, 6).astype(np.float32)
        cd = rng.uniform(-1e-2, 1e-2, 6).astype(np.float32)
        lat = tlat.LatencyStats(torch.zeros(6, H), torch.from_numpy(hist),
                                torch.from_numpy(sd), torch.from_numpy(cd))
        qs = (0.5, 0.9, 0.99)
        got_q = tlat.latency_quantiles(lat.hist, qs, horizon=H,
                                       n_bins=NB).numpy()
        got_m = tlat.latency_mean(lat).numpy()
        for b in range(6):
            jl = jlat.LatencyStats(jnp.zeros(H), hist[b], sd[b], cd[b])
            np.testing.assert_array_equal(got_q[b], np.asarray(
                jlat.latency_quantiles(jl.hist, qs, horizon=H, n_bins=NB)))
            assert got_m[b] == float(jlat.latency_mean(jl)), b
        assert got_m[2] == 0.0 and (got_q[2] == 0.0).all()


# ---------------------------------------------------------------------------
# admission gate
# ---------------------------------------------------------------------------

class TestAdmission:
    CFG = ts.AdmissionConfig(shed_tol=0.10, gap_tol=0.05, readmit_tol=0.02,
                             k_shed=2, k_readmit=2)
    WIN, BURN = 64, 128

    def test_admit_applies_gate_and_counts(self):
        adm = ts.AdmissionState.zero(1, 2, "cpu")
        arr = torch.tensor([[3.0, 1.0]])
        adm, tot = ts.admission_admit(adm, arr)
        assert float(tot[0]) == 4.0
        adm = adm.replace(gate=torch.zeros(1))
        adm, tot = ts.admission_admit(adm, arr)
        assert float(tot[0]) == 0.0
        np.testing.assert_allclose(adm.admitted.numpy()[0], [3.0, 1.0])
        np.testing.assert_allclose(adm.shed.numpy()[0], [3.0, 1.0])

    def _drive(self, T, service=3.0, arrivals=5.0, lam=4.0, drift=None):
        """Closed loop: the queue grows while the gate admits and drains
        while it sheds.  Returns the per-slot gate trace and the state."""
        drift = drift or DriftStats.zero(1, "cpu")
        adm = ts.AdmissionState.zero(1, 1, "cpu")
        q = dlv = 0.0
        gates = []
        for t in range(T):
            adm, admitted = ts.admission_admit(adm,
                                               torch.tensor([[arrivals]]))
            q = max(q + float(admitted[0]) - service, 0.0)
            dlv += service if q > 0 or float(admitted[0]) > 0 else 0.0
            adm = ts.admission_update(
                self.CFG, adm, torch.tensor([t], dtype=torch.int32),
                torch.tensor([q]), torch.tensor([dlv]), torch.tensor([lam]),
                drift, window=self.WIN, burn_in=self.BURN)
            gates.append(float(adm.gate[0]))
        return np.asarray(gates), adm

    def test_gate_moves_only_at_window_boundaries(self):
        gates, _ = self._drive(8 * self.WIN)
        flips = np.nonzero(np.diff(gates))[0] + 1
        assert len(flips) > 0
        assert all((f + 1) % self.WIN == 0 for f in flips)

    def test_hysteresis_flip_spacing(self):
        gates, adm = self._drive(32 * self.WIN)
        flips = np.nonzero(np.diff(gates))[0] + 1
        assert len(flips) >= 2
        k = min(self.CFG.k_shed, self.CFG.k_readmit)
        assert np.all(np.diff(flips) >= k * self.WIN), flips
        assert int(adm.flips[0]) == len(flips)

    def test_underload_never_closes(self):
        gates, adm = self._drive(16 * self.WIN, service=7.0)
        assert np.all(gates == 1.0) and int(adm.flips[0]) == 0

    def test_burn_in_suppresses_early_evidence(self):
        adm = ts.AdmissionState.zero(1, 1, "cpu")
        for t in range(4 * self.WIN):
            adm, _ = ts.admission_admit(adm, torch.tensor([[9.0]]))
            adm = ts.admission_update(
                self.CFG, adm, torch.tensor([t], dtype=torch.int32),
                torch.tensor([9.0 * (t + 1)]), torch.tensor([0.0]),
                torch.tensor([4.0]), DriftStats.zero(1, "cpu"),
                window=self.WIN, burn_in=100 * self.WIN)
        assert float(adm.gate[0]) == 1.0 and int(adm.flips[0]) == 0

    def test_unstable_run_corroborates_first_close_only(self):
        streak = dataclasses.replace(DriftStats.zero(1, "cpu"),
                                     unstable_run=torch.ones(
                                         1, dtype=torch.int32))
        adm = ts.AdmissionState.zero(1, 1, "cpu")
        zero, lam = torch.tensor([0.0]), torch.tensor([4.0])

        def run(adm, ts_):
            for t in ts_:
                adm = ts.admission_update(
                    self.CFG, adm, torch.tensor([t], dtype=torch.int32),
                    zero, zero, lam, streak, window=self.WIN,
                    burn_in=self.BURN)
            return adm
        n1 = self.BURN + 2 * self.WIN
        adm = run(adm, range(n1))
        assert float(adm.gate[0]) == 0.0
        adm = run(adm, range(n1, n1 + 2 * self.WIN))
        assert float(adm.gate[0]) == 1.0
        adm = run(adm, range(n1 + 2 * self.WIN, n1 + 10 * self.WIN))
        assert float(adm.gate[0]) == 1.0 and int(adm.flips[0]) == 2

    @pytest.mark.parametrize("K", [1, 2])
    def test_bit_exact_against_the_reference(self, K):
        """Random multi-window sequences on six sims (arrivals, backlog,
        deliveries, rates, drift streaks and slot offsets all random),
        through `admission_admit` and `admission_update` of both packages:
        every leaf bit-equal after every slot."""
        rng = np.random.default_rng(K)
        B, T, W, burn = 6, 40 * 16, 16, 32
        cfg = ts.AdmissionConfig(k_shed=2, k_readmit=2)
        jcfg = js.AdmissionConfig(k_shed=2, k_readmit=2)
        lam = rng.uniform(0.5, 9.0, B).astype(np.float32)
        offs = rng.integers(0, W, B)
        tadm = ts.AdmissionState.zero(B, K, "cpu")
        jadm = [js.AdmissionState.zero(K) for _ in range(B)]
        jadmit = jax.jit(js.admission_admit)
        jupd = jax.jit(js.admission_update, static_argnums=0,
                       static_argnames=("window", "burn_in"))
        q = np.zeros(B, np.float32)
        dlv = np.zeros(B, np.float32)
        flips = 0
        for t in range(T):
            phase = (t // 96) % 2                 # overload, then drain
            arr = (rng.poisson(lam[:, None] * (1.6 if phase == 0 else 0.4)
                               / K, (B, K)) *
                   rng.uniform(0.5, 1.5, (B, K))).astype(np.float32)
            tadm, tot = ts.admission_admit(tadm, torch.from_numpy(arr))
            served = (lam * rng.uniform(0.8, 1.0, B)).astype(np.float32)
            q = np.maximum(q + tot.numpy() - served, 0).astype(np.float32)
            dlv = (dlv + served).astype(np.float32)
            run = rng.integers(0, 2, B).astype(np.int32)
            tt = (t + offs).astype(np.int32)
            tdrift = dataclasses.replace(DriftStats.zero(B, "cpu"),
                                         unstable_run=torch.from_numpy(run))
            tadm = ts.admission_update(
                cfg, tadm, torch.from_numpy(tt), torch.from_numpy(q),
                torch.from_numpy(dlv), torch.from_numpy(lam), tdrift,
                window=W, burn_in=burn)
            for b in range(B):
                jadm[b], jtot = jadmit(jadm[b], arr[b])
                assert float(jtot) == float(tot[b])
                jdrift = JDrift.zero()._replace(unstable_run=jnp.int32(run[b]))
                jadm[b] = jupd(jcfg, jadm[b], jnp.int32(tt[b]), q[b], dlv[b],
                               lam[b], jdrift, window=W, burn_in=burn)
            if t % 37 == 0 or t == T - 1:
                for b in range(B):
                    for f in js.AdmissionState._fields:
                        np.testing.assert_array_equal(
                            getattr(tadm, f).numpy()[b],
                            np.asarray(getattr(jadm[b], f)),
                            err_msg=f"{f} sim {b} slot {t}")
        flips = int(tadm.flips.sum())
        assert flips >= B, flips        # the sequences exercise the gate


# ---------------------------------------------------------------------------
# scheduler and engine
# ---------------------------------------------------------------------------

def _jax_noise(spec, lam, seed, T, n_comp):
    """The per-class arrivals and regulator bits inside the reference's
    serving slot: fold_in(PRNGKey(seed), t) split in three, the first key
    to the trace's `draw_arrivals`, the third to the regulator."""
    jp = jscenario("paper_grid").build(0)
    pp = jpad(jp, JDims.of([jp]))
    key = jax.random.PRNGKey(seed)
    lam = jnp.float32(lam)

    def body(tr, t):
        k_cls, _, k_step = jax.random.split(jax.random.fold_in(key, t), 3)
        a, tr2 = js.draw_arrivals(spec, k_cls, lam, t, tr, JMod.init(pp))
        return tr2, (a, jax.random.bernoulli(k_step, EPS, (n_comp,)))
    _, (a, r) = jax.jit(lambda: jax.lax.scan(
        body, js.TraceState.init(spec), jnp.arange(T)))()
    return np.asarray(a, np.float32), np.asarray(r, np.float32)


@pytest.mark.parametrize("trace", ["bursty", "bursty_mix"])
def test_whole_run_on_the_references_noise_matches(trace):
    """paper_grid at 0.95x and 1.3x the exact bound, T=2048, chunk=256:
    the port's runner fed the reference's class arrivals and regulator
    bits through its seam reaches the reference's finalize within 1e-5
    relative, with the same verdict, gate and gate flips."""
    T, chunk = 2048, 256
    bound = policy_bound_exact("paper_grid", "pi3_reg", EPS, 0)
    lanes = ((0.95, 0), (1.3, 1))
    jp = jscenario("paper_grid").build(0)
    jpp = jpad(jp, JDims.of([jp]))
    jrun = js.make_serving_runner(JConfig(name="pi3_reg", eps_b=EPS),
                                  js.get_trace(trace), T=T, chunk=chunk)
    ek = jnp.int32(event_code(jscenario("paper_grid").events))
    want, arrs, regs = [], [], []
    for frac, seed in lanes:
        out = jax.jit(jrun)(jpp, jnp.float32(frac * bound), jnp.float32(EPS),
                            ek, jax.random.PRNGKey(seed))
        want.append({k: np.asarray(v) for k, v in out.items()})
        a, r = _jax_noise(js.get_trace(trace), frac * bound, seed, T,
                          jpp.n_comp)
        arrs.append(a)
        regs.append(r)
    runner = ts.make_serving_runner(PolicyConfig("pi3_reg", eps_b=EPS),
                                    ts.get_trace(trace), T=T, chunk=chunk)
    inp = runner.make_inputs(_pp(B=2), [f * bound for f, _ in lanes],
                             [EPS, EPS], [0, 0], [s for _, s in lanes])
    got = runner.run(inp, torch.from_numpy(np.stack(arrs)),
                     torch.from_numpy(np.stack(regs)))
    assert set(got) == set(want[0])
    for b in range(2):
        for k in ("verdict", "gate", "gate_flips", "decided_at_slot"):
            assert float(got[k][b]) == float(want[b][k]), (trace, b, k)
        for k, v in got.items():
            np.testing.assert_allclose(v[b].numpy(), want[b][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{trace} {b} {k}")
    assert float(got["gate_flips"].sum()) >= 1       # the gate moved
    assert float(got["shed_frac"][1]) > 0.05


def test_chunked_equals_closed_bitwise():
    """The chunk-by-chunk surface (init_carry, chunk_step, finalize), the
    slot-by-slot `run` on the same noise, and `run_serving` through its
    `GroupLaunch` give the same metrics bit for bit."""
    T, chunk = 256, 64
    runner = ts.make_serving_runner(PolicyConfig("pi3_reg", eps_b=EPS),
                                    ts.get_trace("bursty"), T=T, chunk=chunk)
    inp = runner.make_inputs(_pp(B=2), [4.0, 9.0], [EPS, EPS], [0, 0],
                             [3, 4])
    carry = runner.init_carry(inp.pp)
    for _ in range(runner.n_chunks):
        runner.chunk_step(inp, carry)
    chunked = runner.finalize(inp, carry)
    closed = runner.run(inp)
    res = ts.run_serving([ts.ServingJob(lam=lam, seed=s)
                          for lam, s in ((4.0, 3), (9.0, 4))],
                         T=T, chunk=chunk, device="cpu")
    assert set(chunked) == set(closed)
    for k in chunked:
        np.testing.assert_array_equal(chunked[k].numpy(), closed[k].numpy(),
                                      err_msg=k)
        for b in range(2):
            np.testing.assert_array_equal(np.asarray(res.metrics[b][k]),
                                          chunked[k][b].numpy(), err_msg=k)
    assert res.n_programs == 1 and res.slot_steps == T


def test_lanes_are_independent_and_groups_split_by_trace():
    dims = tfleet.PadDims(16, 51, 4)
    jobs = [ts.ServingJob("paper_grid", trace="bursty", lam=7.0, seed=1),
            ts.ServingJob("ring", trace="bursty", lam=2.0, seed=2,
                          topo_seed=1),
            ts.ServingJob("ge_grid", trace="steady", lam=5.0, seed=3)]
    kw = dict(T=128, chunk=64, device="cpu", dims=dims)
    batch = ts.run_serving(jobs, **kw)
    assert batch.n_programs == 2 and batch.n_sims == 3
    alone = ts.run_serving(jobs[1:2], **kw)
    assert alone.metrics[0] == batch.metrics[1]


def test_run_serving_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.run_serving([ts.ServingJob()], T=64, chunk=64)


@pytest.fixture(scope="module")
def overload():
    bound = policy_bound_exact("paper_grid", "pi3_reg", EPS, 0)
    jobs = [ts.ServingJob(trace="bursty_mix", lam=1.3 * bound, seed=s)
            for s in (0, 1)]
    return ts.run_serving(jobs, T=4096, chunk=512, device="cpu")


def test_overload_fairness_across_classes(overload):
    """Class-uniform shedding: under 1.3x-bound overload of the
    half-bursty mixture, both classes keep the same admitted share, and
    the gate flips at most once per two admission windows."""
    for m in overload.metrics:
        fa, fb = m["class_admit_frac"]
        assert m["shed_frac"] > 0.1
        assert abs(fa - fb) < 0.05, (fa, fb)
        assert 0.4 < fa < 0.9
    n_windows = 4096 // 512
    assert np.all(overload.column("gate_flips") <= n_windows // 2)


def test_outage_sheds_then_recovers():
    """Comp-node outage mid-trace (outage_grid, slots [1024, 1536)): the
    gate sheds during the outage and re-admits after it, and every stream
    record after t=3072 reads delivered QPS >= 0.9 x bound."""
    bound = policy_bound_exact("outage_grid", "pi3_reg", EPS, 0)
    jobs = [ts.ServingJob(scenario="outage_grid", trace="bursty",
                          lam=0.95 * bound, seed=s) for s in (0, 1)]
    res = ts.run_serving(jobs, T=4096, chunk=256, device="cpu", stream=True)
    assert np.all(res.column("shed_frac") > 0.05), res.column("shed_frac")
    assert np.all(res.column("gate") == 1.0)
    assert np.all(res.column("gate_flips") >= 2.0)
    assert len(res.stream_records) == 4096 // 256
    tail = [r for r in res.stream_records if r["t"] > 3072]
    assert tail
    for r in tail:
        assert r["qps_med"] >= 0.9 * bound, r
