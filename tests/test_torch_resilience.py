"""The port's resilience plane (`repro_torch.runtime.resilience`,
`repro_torch.checkpoint`) on the CPU.

Kill-and-resume is held port against port: a run killed at a chunk
boundary and resumed must give the uninterrupted port run's metrics,
slot accounting, brackets and stream records bit for bit, in all three
engines.  Checkpoint hardening, the fault plane and the stream sink's
resume mode are ported from tests/test_resilience.py; the fault plane,
run signature, host masks, recovery plans, appended streams and
checkpoint manifests are held against the reference's; and a carry saved
and restored mid-run on JAX's noise still reaches the reference's
metrics.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import fleet as jfleet  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.core.policies import PolicyConfig as JConfig  # noqa: E402
from repro.obs.emitter import StreamSink as JSink  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import resilience as jres  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.checkpoint import (Checkpointer,  # noqa: E402
                                    CheckpointCorruption)
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.fleet import (FleetJob, registry_cells,  # noqa: E402
                               run_fleet, sweep_lambda_max)
from repro_torch.fleet import engine as tengine  # noqa: E402
from repro_torch.obs import schema  # noqa: E402
from repro_torch.obs.emitter import StreamSink  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime import (FaultExhausted, FaultPlane,  # noqa: E402
                                 InjectedFault, Preempted, ResilienceConfig,
                                 host_lane_mask, maybe_resilient,
                                 plan_recovery, run_signature)
from repro_torch.serving import ServingJob, run_serving  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Checkpointer hardening: atomic publish, checksums, corruption fallback
# ---------------------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 3), generator=g),
            "t": torch.tensor(seed, dtype=torch.int32)}


class TestCheckpointer:
    def test_save_restore_with_extra_payload(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=2)
        st = _state(1)
        ck.save(1, st, extra={"group": 0, "launched": 3, "pi": 0.25})
        out = ck.restore(st)
        torch.testing.assert_close(out["a"], st["a"], rtol=0, atol=0)
        assert out["t"].dtype == torch.int32 and int(out["t"]) == 1
        assert ck.extra(1) == {"group": 0, "launched": 3, "pi": 0.25}
        # atomic publish: no tmp dirs survive a completed save
        assert not list(tmp_path.glob(".tmp_*"))

    def test_background_save_then_wait(self, tmp_path):
        ck = Checkpointer(tmp_path)
        st = _state(1)
        ck.save(1, st, blocking=False)
        st["a"].zero_()             # the host copy was taken before return
        ck.wait()
        assert ck.all_steps() == [1]
        torch.testing.assert_close(ck.restore(_state(0))["a"],
                                   _state(1)["a"], rtol=0, atol=0)

    def test_corruption_detected_and_fallback(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=3)
        ck.save(1, _state(1), extra={"step": 1})
        ck.save(2, _state(2), extra={"step": 2})
        # torn write / bit rot in the newest step's array payload
        arr = tmp_path / "step_00000002" / "arr_0.npy"
        raw = bytearray(arr.read_bytes())
        raw[-1] ^= 0xFF
        arr.write_bytes(bytes(raw))
        with pytest.raises(CheckpointCorruption, match="sha256"):
            ck.restore(_state(0))
        # fallback walks back to the newest intact step: one snapshot
        # interval lost, never the run
        assert ck.restored_step(fallback=True) == 1
        out = ck.restore(_state(0), fallback=True)
        torch.testing.assert_close(out["a"], _state(1)["a"], rtol=0, atol=0)

    def test_unreadable_manifest_falls_back(self, tmp_path):
        ck = Checkpointer(tmp_path)
        ck.save(1, _state(1))
        ck.save(2, _state(2))
        (tmp_path / "step_00000002" / "manifest.json").write_text("{tor")
        assert ck.restored_step(fallback=True) == 1

    def test_keep_last_k_gc(self, tmp_path):
        ck = Checkpointer(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, _state(s))
        assert ck.all_steps() == [3, 4]

    def test_restore_into_writes_in_place(self, tmp_path):
        """``into``: the stored arrays land in the given tensors (the
        static carry a captured graph reads); nothing is rebound."""
        ck = Checkpointer(tmp_path)
        ck.save(1, _state(1))
        into = _state(0)
        ptrs = {k: v.data_ptr() for k, v in into.items()}
        out = ck.restore(into, into=into)
        assert out is into
        assert {k: v.data_ptr() for k, v in into.items()} == ptrs
        torch.testing.assert_close(into["a"], _state(1)["a"], rtol=0,
                                   atol=0)
        with pytest.raises(ValueError, match="structure"):
            ck.restore({"a": into["a"], "u": into["t"]})

    def test_bfloat16_leaves_round_trip_as_bits(self, tmp_path):
        g = torch.Generator().manual_seed(3)
        w = (torch.randn((5, 7), generator=g) * 1e3).to(torch.bfloat16)
        w[0, :3] = torch.tensor([float("inf"), float("-inf"), -0.0])
        tree = (w, {"m": torch.ones(2, dtype=torch.bfloat16)})
        ck = Checkpointer(tmp_path)
        ck.save(5, tree)
        manifest = json.loads(
            (tmp_path / "step_00000005" / "manifest.json").read_text())
        assert manifest["dtypes"] == ["bfloat16", "bfloat16"]
        assert np.load(tmp_path / "step_00000005" / "arr_0.npy").dtype == \
            np.uint16
        out = ck.restore(tree)
        assert out[0].dtype == torch.bfloat16
        assert torch.equal(out[0].view(torch.int16), w.view(torch.int16))
        assert torch.equal(out[1]["m"], tree[1]["m"])


# ---------------------------------------------------------------------------
# Fault plane: deterministic schedules, bounded retry, dropout sets
# ---------------------------------------------------------------------------

class TestFaultPlane:
    def test_preempt_fires_exactly_once_at_boundary(self):
        fp = FaultPlane.preempt_after(3)
        fp.maybe_preempt(2)
        with pytest.raises(Preempted):
            fp.maybe_preempt(3)
        fp.maybe_preempt(4)

    def test_launch_fail_budget_is_shared_across_attempts(self):
        fp = FaultPlane.launch_fail(at_launch=5, fails=2)
        for _ in range(2):
            with pytest.raises(InjectedFault):
                fp.on_launch(0, 5)
        fp.on_launch(0, 5)          # budget spent: the retry succeeds
        assert fp.n_injected == 2

    def test_dead_hosts_monotone(self):
        fp = FaultPlane([*FaultPlane.host_dropout(2, at_launch=1).specs,
                         *FaultPlane.host_dropout(0, at_launch=3).specs])
        assert fp.dead_hosts(0) == ()
        assert fp.dead_hosts(1) == (2,)
        assert fp.dead_hosts(3) == (0, 2)
        assert fp.dead_hosts(99) == (0, 2)

    def test_host_lane_mask_contiguous_blocks(self):
        mask = host_lane_mask(8, 4, (1, 3))
        np.testing.assert_array_equal(
            mask, [False, False, True, True, False, False, True, True])
        # the port's one device: host 0 holds every lane
        assert host_lane_mask(5, 1, (0,)).all()
        assert not host_lane_mask(5, 1, (1,)).any()

    def test_retry_recovers_within_budget(self):
        rt = maybe_resilient(
            ResilienceConfig(fault_plane=FaultPlane.launch_fail(0, fails=2),
                             max_retries=3),
            "unit")
        calls = []
        out = rt.launch(0, 0, lambda x: calls.append(x) or x, 7)
        assert out == 7 and calls == [7]
        assert rt.n_retries == 2

    def test_retry_exhaustion_raises(self):
        rt = maybe_resilient(
            ResilienceConfig(fault_plane=FaultPlane.launch_fail(0, fails=9),
                             max_retries=2),
            "unit")
        with pytest.raises(FaultExhausted):
            rt.launch(0, 0, lambda: 0)
        assert rt.n_retries == 3    # initial + 2 retries, all failed

    def test_signature_guards_against_run_blending(self, tmp_path):
        assert run_signature("fleet", T=512) == run_signature("fleet", T=512)
        assert run_signature("fleet", T=512) != run_signature("fleet", T=256)
        ck = Checkpointer(tmp_path)
        ck.save(1, (), extra={"engine": "fleet",
                              "signature": run_signature("fleet", T=512)})
        with pytest.raises(ValueError, match="signature mismatch"):
            maybe_resilient(ResilienceConfig(checkpoint_dir=str(tmp_path)),
                            "fleet", T=256)
        with pytest.raises(ValueError, match="belongs to"):
            maybe_resilient(ResilienceConfig(checkpoint_dir=str(tmp_path)),
                            "serving", T=512)


# ---------------------------------------------------------------------------
# The control plane against the reference's
# ---------------------------------------------------------------------------

SIG_PARAMS = [dict(T=512, chunk=128, window=None, early_stop=True, ndev=1),
              dict(T=4096, chunk=512, seeds=(0, 1, 2), rel_tol=0.025,
                   bracket=(0.5, 1.1), max_calls=24, n_buckets=3,
                   max_requeues=1, ndev=1),
              dict()]


@pytest.mark.parametrize("engine", ["fleet", "serving", "atlas"])
def test_run_signature_matches_reference(engine):
    for params in SIG_PARAMS:
        assert run_signature(engine, **params) == \
            jres.run_signature(engine, **params)


def test_host_lane_mask_and_plan_recovery_match_reference():
    for Bp in (1, 4, 8, 12):
        for ndev in (1, 2, 4):
            if Bp % ndev:
                continue
            for dead in ((), (0,), (1,), (0, 3), (5,)):
                np.testing.assert_array_equal(
                    host_lane_mask(Bp, ndev, dead),
                    jres.host_lane_mask(Bp, ndev, dead))
    for n_hosts in (1, 2, 4):
        for dead in ([], ["host0"], ["host0", "host1"]):
            for slow in ([], ["host1"]):
                for mp in (1, 2, 4):
                    got = plan_recovery(n_hosts, 2, dead, slow, mp)
                    want = jfault.plan_recovery(n_hosts, 2, dead, slow, mp)
                    assert (got.action, got.evict, got.new_mesh_shape,
                            got.note) == (want.action, want.evict,
                                          want.new_mesh_shape, want.note)


FAULT_GRID = [
    [("launch_fail", dict(at_launch=1, fails=2))],
    [("launch_fail", dict(at_launch=0, fails=1, group=1))],
    [("preempt", dict(at_launch=3))],
    [("host_dropout", dict(host=0, at_launch=2)),
     ("host_dropout", dict(host=2, at_launch=1))],
    [("launch_fail", dict(at_launch=2, fails=3)),
     ("preempt", dict(at_launch=2)),
     ("host_dropout", dict(host=1, at_launch=4))],
]


def _drive(mod, specs):
    """A fixed schedule of scheduler hooks on ``mod``'s FaultPlane: what
    each call raised or returned, the log and the injection count."""
    fp = mod.FaultPlane([mod.FaultSpec(kind, **kw) for kind, kw in specs])
    seen = []
    for launch in range(6):
        for group in (0, 1):
            for _ in range(2):
                try:
                    fp.on_launch(group, launch)
                    seen.append("ok")
                except mod.InjectedFault as e:
                    seen.append(("InjectedFault", str(e)))
        try:
            fp.maybe_preempt(launch)
            seen.append("ok")
        except mod.Preempted as e:
            seen.append(("Preempted", str(e)))
        seen.append(fp.dead_hosts(launch))
    return seen, fp.log, fp.n_injected


@pytest.mark.parametrize("specs", FAULT_GRID)
def test_fault_plane_matches_reference(specs):
    assert _drive(tfault, specs) == _drive(jfault, specs)


def _fleet_rec(chunk, t, **over):
    fields = dict(group=0, chunk=chunk, t=t, n_sims=4,
                  useful_rate_med=0.5, backlog_med=0.1, max_queue_med=3.0,
                  drift_med=-0.01, n_decided=1, verdicts={"UNDECIDED": 4})
    fields.update(over)
    return schema.make_record("fleet", **fields)


def _resume_rec(chunk, t):
    return schema.make_record("resume", group=0, chunk=chunk, t=t,
                              n_sims=4, engine="fleet", ckpt_step=chunk,
                              n_preloaded=chunk)


def test_appended_stream_matches_reference(tmp_path):
    """Each package's sink in append mode, fed the same preloaded file (a
    torn last line included) and the same records, leaves the same
    bytes."""
    pre = (schema.jsonl_line(_fleet_rec(0, 64)) + "\n"
           + schema.jsonl_line(_fleet_rec(1, 128, group=1)) + "\n"
           + schema.jsonl_line(_fleet_rec(1, 128)) + "\n" + '{"kind": "fl')
    seq = [_resume_rec(1, 128), _fleet_rec(1, 128), _fleet_rec(0, 64),
           _fleet_rec(2, 192), _fleet_rec(1, 128, group=1),
           _fleet_rec(2, 192, group=1), _resume_rec(2, 192),
           _fleet_rec(3, 256)]
    files = {}
    for name, cls in (("port", StreamSink), ("reference", JSink)):
        path = tmp_path / f"{name}_stream.jsonl"
        path.write_text(pre)
        sink = cls(path=str(path), append=True)
        assert sink.n_preloaded == 3
        for rec in seq:
            sink.write(dict(rec))
        sink.close()
        files[name] = path.read_bytes()
    assert files["port"] == files["reference"]
    assert schema.validate_stream(
        schema.read_stream_jsonl(str(tmp_path / "port_stream.jsonl"))) == []


def test_checkpoint_manifest_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    arrays = {"q": rng.standard_normal((6, 5)).astype(np.float32),
              "t": rng.integers(0, 999, (6,)).astype(np.int32),
              "seed": rng.integers(0, 2 ** 40, (6,)).astype(np.int64),
              "cdf": rng.random((6, 9)),
              "mask": rng.random((6,)) < 0.5,
              "z": np.zeros((0, 3), np.float32)}
    Checkpointer(tmp_path / "port").save(
        3, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    JCheckpointer(tmp_path / "ref").save(3, arrays)
    m = {name: json.loads((tmp_path / name / "step_00000003" /
                           "manifest.json").read_text())
         for name in ("port", "ref")}
    for key in ("sha256", "dtypes", "shapes", "n_arrays", "step"):
        assert m["port"][key] == m["ref"][key], key


# ---------------------------------------------------------------------------
# Kill-and-resume bit-equality, all three engines
# ---------------------------------------------------------------------------

FLEET_JOBS = [FleetJob(scenario=scen, policy="pi3_reg", lam=lam,
                       eps_b=0.05, seed=s)
              for scen, lam in (("paper_grid", 4.0), ("ge_grid", 3.0))
              for s in (0, 1)]
FLEET_KW = dict(T=512, chunk=128, device="cpu")
SERVING_JOBS = [ServingJob(trace="bursty", lam=3.0, seed=s) for s in (0, 1)]
SERVING_KW = dict(T=512, chunk=128, device="cpu")
ATLAS_CELLS = registry_cells(("paper_grid", "ring"), topo_seeds=(0, 1),
                             eps_b=0.05)
ATLAS_KW = dict(seeds=(0,), T=512, chunk=256, rel_tol=0.1, max_calls=4,
                device="cpu")


def _metrics_equal(off, on):
    assert len(off) == len(on)
    for m0, m1 in zip(off, on):
        assert set(m0) == set(m1)
        for k in m0:
            assert m0[k] == m1[k], (k, m0[k], m1[k])


def _stream_equal(base_path, resumed_path):
    """The resumed file, resume seam records stripped, must be the base
    stream byte for byte (records are canonical sorted-key JSON)."""
    base = pathlib.Path(base_path).read_text().splitlines()
    merged = pathlib.Path(resumed_path).read_text().splitlines()
    recs = [json.loads(x) for x in merged]
    seams = [r for r in recs if r["kind"] == "resume"]
    assert seams, "resumed run emitted no resume record"
    assert [ln for ln, r in zip(merged, recs) if r["kind"] != "resume"] \
        == base
    assert schema.validate_stream(recs) == []
    return seams


def _kill_and_resume(run, kill_at, ckpt_dir, stream_path, **cfg):
    """Run `run` with a preempt at boundary `kill_at`, then resume it."""
    with pytest.raises(Preempted):
        run(resilience=ResilienceConfig(
            checkpoint_dir=str(ckpt_dir),
            fault_plane=FaultPlane.preempt_after(kill_at), **cfg),
            stream_path=str(stream_path))
    return run(resilience=ResilienceConfig(checkpoint_dir=str(ckpt_dir),
                                           **cfg),
               stream_path=str(stream_path))


@pytest.fixture(scope="module")
def fleet_base(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet") / "base_stream.jsonl"
    return run_fleet(FLEET_JOBS, **FLEET_KW, stream_path=str(path)), path


@pytest.fixture(scope="module")
def atlas_base(tmp_path_factory):
    path = tmp_path_factory.mktemp("atlas") / "base_stream.jsonl"
    return sweep_lambda_max(ATLAS_CELLS, **ATLAS_KW,
                            stream_path=str(path)), path


class TestFleetResume:
    # one group, 4 chunks: every boundary incl. the last (after the chunk,
    # before the finalize; the resume recomputes the finalize)
    @pytest.mark.parametrize("kill_at", range(1, 5))
    def test_kill_at_every_boundary_bit_exact(self, fleet_base, tmp_path,
                                              kill_at):
        base_res, base_path = fleet_base
        res = _kill_and_resume(
            lambda **kw: run_fleet(FLEET_JOBS, **FLEET_KW, **kw),
            kill_at, tmp_path / "ckpt", tmp_path / "stream.jsonl")
        _metrics_equal(base_res.metrics, res.metrics)
        assert res.slots_saved == base_res.slots_saved
        assert res.launch_slots_saved == base_res.launch_slots_saved
        assert res.resumed_from == kill_at
        assert res.slot_steps == base_res.slot_steps - kill_at * 128
        assert res.degraded == {} and res.n_fault_retries == 0
        # the memoized launcher: a same-process resume makes none anew
        assert res.n_step_compiles == base_res.n_step_compiles
        seams = _stream_equal(base_path, tmp_path / "stream.jsonl")
        assert seams[0]["engine"] == "fleet"
        assert seams[0]["ckpt_step"] == kill_at

    def test_early_stop_resume_bit_exact(self, tmp_path):
        kw = dict(T=2048, chunk=256, early_stop=True, device="cpu")
        base = run_fleet(FLEET_JOBS, **kw)
        res = _kill_and_resume(
            lambda **over: run_fleet(FLEET_JOBS, **kw, **over),
            2, tmp_path / "ckpt", tmp_path / "stream.jsonl",
            blocking=False)
        _metrics_equal(base.metrics, res.metrics)
        assert res.slots_saved == base.slots_saved
        assert res.launch_slots_saved == base.launch_slots_saved

    def test_resume_false_starts_fresh(self, fleet_base, tmp_path):
        base_res, _ = fleet_base
        with pytest.raises(Preempted):
            run_fleet(FLEET_JOBS, **FLEET_KW,
                      resilience=ResilienceConfig(
                          checkpoint_dir=str(tmp_path),
                          fault_plane=FaultPlane.preempt_after(2)))
        res = run_fleet(FLEET_JOBS, **FLEET_KW,
                        resilience=ResilienceConfig(
                            checkpoint_dir=str(tmp_path), resume=False))
        assert res.resumed_from is None
        _metrics_equal(base_res.metrics, res.metrics)


class TestServingResume:
    @pytest.fixture(scope="class")
    def base(self, tmp_path_factory):
        path = tmp_path_factory.mktemp("serving") / "base_stream.jsonl"
        res = run_serving(SERVING_JOBS, **SERVING_KW,
                          stream_path=str(path))
        return res, path

    @pytest.mark.parametrize("kill_at", range(1, 5))
    def test_kill_at_every_boundary_bit_exact(self, base, tmp_path,
                                              kill_at):
        base_res, base_path = base
        res = _kill_and_resume(
            lambda **kw: run_serving(SERVING_JOBS, **SERVING_KW, **kw),
            kill_at, tmp_path / "ckpt", tmp_path / "stream.jsonl")
        _metrics_equal(base_res.metrics, res.metrics)
        assert res.resumed_from == kill_at
        assert res.n_step_compiles == base_res.n_step_compiles
        seams = _stream_equal(base_path, tmp_path / "stream.jsonl")
        assert seams[0]["engine"] == "serving"


class TestAtlasResume:
    @pytest.mark.parametrize("kill_at", range(1, 8))
    def test_kill_at_every_boundary_bit_exact(self, atlas_base, tmp_path,
                                              kill_at):
        base_res, base_path = atlas_base
        assert base_res.n_launches >= 8
        res = _kill_and_resume(
            lambda **kw: sweep_lambda_max(ATLAS_CELLS, **ATLAS_KW, **kw),
            kill_at, tmp_path / "ckpt", tmp_path / "stream.jsonl")
        # rows are frozen dataclasses (brackets, probes, slot accounting):
        # == is full bit-equality of the lambda_max search
        assert res.rows == base_res.rows
        assert res.n_launches == base_res.n_launches
        assert res.seq_launches == base_res.seq_launches
        assert res.n_rewrites == base_res.n_rewrites
        assert res.launch_slots_saved == base_res.launch_slots_saved
        assert res.resumed_from == kill_at
        # the memoized launcher: a same-process resume makes none anew
        assert res.n_step_compiles == base_res.n_step_compiles
        seams = _stream_equal(base_path, tmp_path / "stream.jsonl")
        assert seams[0]["engine"] == "atlas"


class TestBucketedRequeueResume:
    """The snapshot carries the bucketed atlas's cursor: the batch index,
    the per-bucket launch counters and the per-cell attempt counters, so a
    sweep killed mid-re-queue or mid-bucket resumes bit for bit.

    paper_grid and ring land in different size buckets; T=256 at
    chunk=128 cannot latch a verdict (the earliest is slot 6 x chunk), so
    every cell escalates through both re-queues and every boundary is
    mid-bucket or mid-attempt.  Smaller than the reference's (T=512,
    chunk=256, max_calls=4: a 70 s sweep on this path), with the same
    structure, and one sweep killed at every kill point in turn, each
    resume picking up the seam the last one left."""

    CELLS = registry_cells(("paper_grid", "ring"), topo_seeds=(0,),
                           eps_b=0.05)
    KW = dict(seeds=(0,), T=256, chunk=128, rel_tol=0.1, max_calls=2,
              n_buckets=2, max_requeues=2, device="cpu")

    def test_kill_mid_requeue_and_mid_bucket_bit_exact(self, tmp_path):
        base_path = tmp_path / "base_stream.jsonl"
        base = sweep_lambda_max(self.CELLS, **self.KW,
                                stream_path=str(base_path))
        assert base.n_buckets == 2
        assert base.n_requeues == 2 * len(self.CELLS)
        n = base.n_launches
        kills = sorted({1, 2, n // 2, n - 1, n})
        ckpt, stream = tmp_path / "ckpt", tmp_path / "stream.jsonl"
        for kill_at in kills:
            with pytest.raises(Preempted):
                sweep_lambda_max(self.CELLS, **self.KW,
                                 stream_path=str(stream),
                                 resilience=ResilienceConfig(
                                     checkpoint_dir=str(ckpt),
                                     fault_plane=FaultPlane.preempt_after(
                                         kill_at)))
        res = sweep_lambda_max(self.CELLS, **self.KW,
                               stream_path=str(stream),
                               resilience=ResilienceConfig(
                                   checkpoint_dir=str(ckpt)))
        assert res.rows == base.rows
        assert res.n_requeues == base.n_requeues
        assert res.bucket_launches == base.bucket_launches
        assert res.bucket_cells == base.bucket_cells
        assert res.n_launches == base.n_launches
        assert res.n_step_compiles == base.n_step_compiles
        assert res.resumed_from == kills[-1]
        # attempt counters survived: per-row re-queue counts intact
        assert [r.n_requeues for r in res.rows] == \
            [r.n_requeues for r in base.rows]
        seams = _stream_equal(base_path, stream)
        assert [s["ckpt_step"] for s in seams] == kills
        assert all(s["engine"] == "atlas" for s in seams)


# ---------------------------------------------------------------------------
# Graceful degradation: host dropout parks lanes, reports, never aborts
# ---------------------------------------------------------------------------

class TestDegradation:
    def test_atlas_host_dropout_degrades_not_aborts(self, atlas_base):
        base, _ = atlas_base
        res = sweep_lambda_max(
            ATLAS_CELLS, **ATLAS_KW,
            resilience=ResilienceConfig(
                fault_plane=FaultPlane.host_dropout(host=0, at_launch=2)))
        assert len(res.rows) == len(ATLAS_CELLS)
        # one device: host 0 holds every lane, so every cell is parked
        assert set(res.degraded) == set(range(len(ATLAS_CELLS)))
        for why in res.degraded.values():
            assert why == "host_dropout:host0"
        assert all(r.degraded for r in res.rows)
        assert res.n_launches == 2
        # the searches up to the dropout are the base's
        for r0, r1 in zip(base.rows, res.rows):
            assert r1.probes == r0.probes[:len(r1.probes)]
        assert res.recovery_plan.action == "remesh"
        assert res.recovery_plan.evict == ("host0",)

    def test_fleet_host_dropout_degrades_not_aborts(self, fleet_base):
        base, _ = fleet_base
        res = run_fleet(FLEET_JOBS, **FLEET_KW,
                        resilience=ResilienceConfig(
                            fault_plane=FaultPlane.host_dropout(
                                host=0, at_launch=2)))
        assert len(res.metrics) == len(FLEET_JOBS)
        assert res.degraded == {j: "host_dropout:host0"
                                for j in range(len(FLEET_JOBS))}
        # parked lanes: verdict forced UNSTABLE, the run goes on
        assert res.verdicts() == ["UNSTABLE"] * len(FLEET_JOBS)
        assert res.slot_steps == base.slot_steps
        assert res.recovery_plan.action == "remesh"
        assert res.recovery_plan.evict == ("host0",)

    def test_fleet_transient_launch_failure_retries(self, fleet_base):
        base, _ = fleet_base
        res = run_fleet(FLEET_JOBS, **FLEET_KW,
                        resilience=ResilienceConfig(
                            fault_plane=FaultPlane.launch_fail(
                                at_launch=1, fails=2)))
        _metrics_equal(base.metrics, res.metrics)
        assert res.n_fault_retries == 2
        assert res.degraded == {}
        with pytest.raises(FaultExhausted):
            run_fleet(FLEET_JOBS, **FLEET_KW,
                      resilience=ResilienceConfig(
                          fault_plane=FaultPlane.launch_fail(
                              at_launch=0, fails=5), max_retries=1))


# ---------------------------------------------------------------------------
# Resume-aware stream append: dedupe clock, seam records, --resumed gate
# ---------------------------------------------------------------------------

class TestStreamResume:
    def test_append_dedupes_by_chunk_clock(self, tmp_path):
        path = tmp_path / "s_stream.jsonl"
        first = StreamSink(path=str(path))
        for c in (0, 1):
            first.write(_fleet_rec(c, 64 * (c + 1)))
        first.close()
        sink = StreamSink(path=str(path), append=True)
        assert sink.n_preloaded == 2
        sink.write(_resume_rec(1, 128))          # seam marker: never deduped
        sink.write(_fleet_rec(1, 128))           # replayed: suppressed
        sink.write(_fleet_rec(2, 192))           # fresh: appended
        sink.close()
        recs = schema.read_stream_jsonl(str(path))
        assert [r["kind"] for r in recs] == ["fleet", "fleet", "resume",
                                             "fleet"]
        assert [r["chunk"] for r in recs if r["kind"] == "fleet"] == \
            [0, 1, 2]
        assert schema.validate_stream(recs) == []

    def test_append_drops_torn_trailing_line(self, tmp_path):
        path = tmp_path / "s_stream.jsonl"
        with open(path, "w") as f:
            f.write(schema.jsonl_line(_fleet_rec(0, 64)) + "\n")
            f.write('{"kind": "fl')               # killed mid-append
        sink = StreamSink(path=str(path), append=True)
        assert sink.n_preloaded == 1
        sink.write(_fleet_rec(1, 128))
        sink.close()
        assert len(schema.read_stream_jsonl(str(path))) == 2

    def test_validate_stream_allows_repeated_resume_seams(self):
        recs = [_fleet_rec(0, 64), _resume_rec(0, 64), _resume_rec(0, 64),
                _fleet_rec(1, 128)]
        assert schema.validate_stream(recs) == []
        dup = [_fleet_rec(0, 64), _fleet_rec(0, 64)]
        assert any("chunk" in e for e in schema.validate_stream(dup))

    def test_check_stream_resumed_gate(self, tmp_path):
        """scripts/check_stream.py --resumed on a stream the port's engine
        wrote across a kill, and on one without a seam."""
        jobs = FLEET_JOBS[:2]
        good = tmp_path / "ok_stream.jsonl"
        with pytest.raises(Preempted):
            run_fleet(jobs, **FLEET_KW, stream_path=str(good),
                      resilience=ResilienceConfig(
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          fault_plane=FaultPlane.preempt_after(2)))
        run_fleet(jobs, **FLEET_KW, stream_path=str(good),
                  resilience=ResilienceConfig(
                      checkpoint_dir=str(tmp_path / "ckpt")))
        r = subprocess.run(
            [sys.executable, "scripts/check_stream.py", "--resumed",
             str(good)], cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        bare = tmp_path / "bare_stream.jsonl"
        sink = StreamSink(path=str(bare))
        sink.write(_fleet_rec(0, 64))
        sink.close()
        r = subprocess.run(
            [sys.executable, "scripts/check_stream.py", "--resumed",
             str(bare)], cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 1
        assert "no resume record" in r.stderr


# ---------------------------------------------------------------------------
# The noise seam survives a checkpoint
# ---------------------------------------------------------------------------

def _jax_regulator_bits(seed, T, NC, eps):
    """The regulator's draws inside the reference's stream runner (as in
    tests/test_torch_fleet.py)."""
    key = jax.random.PRNGKey(seed)

    def bits(t):
        k_step = jax.random.split(jax.random.fold_in(key, t), 3)[2]
        return jax.random.bernoulli(k_step, eps, (NC,))
    return np.asarray(jax.jit(jax.vmap(bits))(jnp.arange(T)), np.float32)


def test_resume_on_reference_noise_reaches_reference(tmp_path):
    """tests/test_torch_fleet.py's seam (arrivals and regulator bits drawn
    by JAX), stepped chunk by chunk: after chunk 2 the carry goes through
    the port's Checkpointer into a fresh carry, and the run goes on from
    there.  Its metrics equal the uninterrupted port run's bit for bit,
    and the reference's within that test's tolerance."""
    T, chunk, eps, policy = 2048, 256, 0.05, "pi3_reg"
    scens, lams, seeds = ("paper_grid", "ring"), (7.2, 2.4), (0, 1)
    rng = np.random.default_rng(21)
    traces = [rng.poisson(lam, T).astype(np.float32) for lam in lams]
    want = []
    for scen, lam, seed, arr in zip(scens, lams, seeds, traces):
        out = jfleet.stream_simulate(jfleet.get_scenario(scen).build(0),
                                     JConfig(name=policy, eps_b=eps), lam, T,
                                     chunk=chunk, seed=seed,
                                     arrivals=jnp.asarray(arr))
        want.append({k: float(v) for k, v in out.items()})
    problems = [tfleet.get_scenario(s).build(0) for s in scens]
    dims = tfleet.PadDims.of(problems)
    pp = tfleet.stack_problems(problems, dims, "cpu")
    reg = np.zeros((2, T, dims.n_comp), np.float32)
    for b, (p, seed) in enumerate(zip(problems, seeds)):
        reg[b, :, :p.n_comp] = _jax_regulator_bits(seed, T, p.n_comp, eps)
    runner = tengine.make_stream_runner(PolicyConfig(name=policy, eps_b=eps),
                                        T, chunk=chunk)
    inp = tengine.make_inputs(pp, lams, [eps, eps], [0, 0], [0, 0], seeds)
    arr_t, reg_t = torch.from_numpy(np.stack(traces)), torch.from_numpy(reg)
    whole = runner.run(inp, arr_t, reg_t)

    ck = Checkpointer(tmp_path)
    carry = runner.init_carry(pp)
    for k in range(T):
        runner.advance(inp, carry, arr_t[:, k], reg_t[:, k])
        if k == 2 * chunk - 1:
            ck.save(2, carry)
            carry = runner.init_carry(pp)
            ck.restore(carry, into=carry)
    got = runner.finalize(inp, carry)
    assert set(got) == set(whole)
    for key in whole:
        assert torch.equal(got[key], whole[key]), key
    for b in range(2):
        g = {k: float(v[b]) for k, v in got.items()}
        assert g["verdict"] == want[b]["verdict"], scens[b]
        assert g["decided_at_slot"] == want[b]["decided_at_slot"], scens[b]
        for k in ("useful_rate", "mean_queue", "delivered_useful"):
            assert g[k] == pytest.approx(want[b][k], rel=0.01), (scens[b], k)

