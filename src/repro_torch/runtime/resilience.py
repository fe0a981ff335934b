"""Preemption-safe engine runs (port of `repro.runtime.resilience`).

The chunk schedulers (`fleet.run_fleet`, `fleet.atlas.sweep_lambda_max`,
`serving.run_serving`) drive host loops of `fleet.engine.GroupLaunch`
steps.  A launch owns static ``inp``/``carry`` tensors that its captured
CUDA graph reads and writes in place, so between two steps the carry is a
settled tree of tensors, and the next step's replay overwrites it.  That
window, the one the verdict readouts and telemetry probes already use, is
the only place a snapshot is taken: the carry is copied to host memory
before `snapshot` returns (read before overwrite, the port's form of the
reference's snapshot-before-donate), then published atomically with the
host-side scheduler state.

What a checkpoint holds:

  * the carry, one array per tensor leaf, and
  * an ``extra`` JSON payload inside the manifest: engine name, a run
    signature, the group/launch cursor, finished per-job metrics, and, for
    the atlas, every cell's serialized `Bisection` machine, `RateProbe`
    history, pending assignments and the lane tables (each lane's offered
    rate and noise seed, and which lanes are parked).  Everything else
    (padded topologies, per-sim constants, captured graphs) is rebuilt
    from the job list.

A restore writes into the launch's existing carry tensors with ``copy_``
(`restore_carry`), never rebinding one, so a graph captured over them
replays the restored state.  Bit-exact resume follows: the carry
round-trips through `.npy` exactly, the slot counter ``t`` rides inside
the carry (so the counter-based noise keyed on (seed, site, t, element)
continues unbroken), JSON round-trips the finished float metrics exactly,
and the memoized `make_group_launch` hands a same-process resume the
launch of the killed run with its graph already captured (no new
capture).  The run signature guards against resuming another run's
checkpoint: it hashes the jobs, horizon, verdict and device-count axes,
and a mismatch raises instead of blending two runs.

`ResilienceConfig.fault_plane` wires `runtime.fault`'s injectable fault
plane into the same loops (transient launch failures -> bounded retry
with backoff; host dropout -> park + re-plan; preemption -> durable
snapshot then raise).  The port runs on one device, so ``ndev`` is 1 and
every lane lives on host 0.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.checkpoint import Checkpointer
from repro_torch.obs import schema
from .fault import (FaultExhausted, FaultPlane, InjectedFault,  # noqa: F401
                    Preempted, RecoveryPlan, plan_recovery)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of one preemption-safe engine run.

    checkpoint_dir : where snapshots live (None = fault plane only).
    every          : snapshot every N-th launch boundary (global count).
    keep           : retained steps (Checkpointer keep-last-k).
    resume         : restore from the newest intact checkpoint if one
                     matches this run's signature; False starts fresh.
    blocking       : False writes the snapshot to disk on a background
                     thread (the copy of the carry to host memory is always
                     synchronous: the next step overwrites it in place).
                     A kill mid-write costs one interval: restore falls
                     back to the previous intact step.
    fault_plane    : injectable fault schedule (`runtime.fault.FaultPlane`).
    max_retries    : bounded retry budget per launch for InjectedFault.
    backoff_s      : base of the exponential retry backoff (0 = immediate).
    """

    checkpoint_dir: Optional[str] = None
    every: int = 1
    keep: int = 3
    resume: bool = True
    blocking: bool = True
    fault_plane: Optional[FaultPlane] = None
    max_retries: int = 3
    backoff_s: float = 0.0


def run_signature(engine: str, **params) -> str:
    """Stable hash of the axes that define a run's identity.

    Jobs/cells are frozen dataclasses and configs are frozen dataclasses
    or ints, so their reprs are deterministic; resuming a checkpoint whose
    signature differs raises rather than blending two different runs."""
    canon = repr((engine, sorted(params.items())))
    return hashlib.sha256(canon.encode()).hexdigest()


def host_lane_mask(Bp: int, ndev: int, dead_hosts) -> np.ndarray:
    """[Bp] bool mask of lanes living on dead hosts.

    The batch is cut into ``ndev`` contiguous blocks, so lane ``l`` lives
    on host ``l // (Bp // ndev)``; with the port's one device every lane
    is host 0's."""
    per = Bp // ndev
    mask = np.zeros(Bp, bool)
    for h in dead_hosts:
        if 0 <= h < ndev:
            mask[h * per:(h + 1) * per] = True
    return mask


def plan_state(plan: Optional[RecoveryPlan]) -> Optional[dict]:
    return None if plan is None else dataclasses.asdict(plan)


def plan_restore(state: Optional[dict]) -> Optional[RecoveryPlan]:
    if state is None:
        return None
    return RecoveryPlan(
        action=state["action"], evict=tuple(state["evict"]),
        new_mesh_shape=(None if state["new_mesh_shape"] is None
                        else tuple(state["new_mesh_shape"])),
        note=state["note"])


# -- host-side scheduler-state serialization (atlas) ------------------------
# RateProbe/AtlasRow are frozen dataclasses of scalars + tuples: a plain
# asdict round-trips through JSON up to tuple->list, undone here.

def probe_state(p) -> dict:
    return dataclasses.asdict(p)


def probe_restore(state: dict):
    from repro_torch.fleet.frontier import RateProbe
    s = dict(state)
    s["verdicts"] = tuple(s["verdicts"])
    s["decided_at"] = tuple(int(x) for x in s["decided_at"])
    return RateProbe(**s)


def row_state(row) -> dict:
    s = dataclasses.asdict(row)
    s["probes"] = [probe_state(p) for p in row.probes]
    return s


def row_restore(state: dict):
    from repro_torch.fleet.atlas import AtlasRow
    s = dict(state)
    s["probes"] = tuple(probe_restore(p) for p in s["probes"])
    return AtlasRow(**s)


class ResilientRun:
    """One engine run's resilience runtime: snapshot/restore + faults.

    Built by the engines when a `ResilienceConfig` is passed; `resumed`
    is the newest intact checkpoint's ``extra`` payload (plus its
    ``ckpt_step``) when there is one to continue from, else None.
    """

    def __init__(self, cfg: ResilienceConfig, engine: str, signature: str):
        self.cfg = cfg
        self.engine = engine
        self.signature = signature
        self.ckpt = (Checkpointer(cfg.checkpoint_dir, keep=cfg.keep)
                     if cfg.checkpoint_dir else None)
        self.fault = cfg.fault_plane
        self.n_retries = 0
        self.resumed: Optional[dict] = None
        if self.ckpt is not None and cfg.resume:
            step = self.ckpt.restored_step(fallback=True)
            if step is not None:
                extra = self.ckpt.extra(step)
                if not extra or extra.get("engine") != engine:
                    raise ValueError(
                        f"{cfg.checkpoint_dir}: checkpoint belongs to "
                        f"engine {extra.get('engine') if extra else None!r}"
                        f", not {engine!r}")
                if extra.get("signature") != signature:
                    raise ValueError(
                        f"{cfg.checkpoint_dir}: checkpoint was written by "
                        "a different run (signature mismatch) — point "
                        "checkpoint_dir elsewhere or pass resume=False")
                self.resumed = dict(extra)
                self.resumed["ckpt_step"] = step

    # -- snapshot / restore -------------------------------------------------

    def should_snapshot(self, launches_done: int) -> bool:
        return (self.ckpt is not None
                and launches_done % max(self.cfg.every, 1) == 0)

    def snapshot(self, step: int, carry: Any, extra: dict) -> None:
        """Publish the carry + scheduler state for this boundary.  The
        carry is copied to host memory here, synchronously, before the
        next step overwrites it in place."""
        if self.ckpt is None:
            return
        self.ckpt.save(step, carry, blocking=self.cfg.blocking,
                       extra={"engine": self.engine,
                              "signature": self.signature, **extra})

    def wait(self) -> None:
        """Let a snapshot still being written in the background land."""
        if self.ckpt is not None:
            self.ckpt.wait()

    def restore_carry(self, launch) -> Any:
        """Write the resumed step's carry into ``launch.carry`` in place
        (``copy_`` into the tensors its captured graph reads); returns
        ``launch.carry``."""
        return self.ckpt.restore(launch.carry,
                                 step=self.resumed["ckpt_step"],
                                 into=launch.carry)

    # -- fault plane --------------------------------------------------------

    def launch(self, group: int, launch_idx: int, fn, *args):
        """Dispatch one launch through the fault plane: InjectedFault
        triggers bounded retry with exponential backoff.  Safe to retry
        because the fault fires before dispatch: the carry is untouched."""
        attempt = 0
        while True:
            try:
                if self.fault is not None:
                    self.fault.on_launch(group, launch_idx)
                return fn(*args)
            except InjectedFault as e:
                attempt += 1
                self.n_retries += 1
                if attempt > self.cfg.max_retries:
                    raise FaultExhausted(
                        f"launch {launch_idx} (group {group}) failed "
                        f"{attempt} times: {e}") from e
                if self.cfg.backoff_s > 0:
                    time.sleep(self.cfg.backoff_s * 2 ** (attempt - 1))

    def maybe_preempt(self, launches_done: int) -> None:
        if self.fault is not None:
            self.fault.maybe_preempt(launches_done)

    def dead_hosts(self, launches_done: int) -> tuple:
        if self.fault is None:
            return ()
        return self.fault.dead_hosts(launches_done)


def maybe_resilient(cfg: "ResilienceConfig | None", engine: str,
                    **sig_params) -> Optional[ResilientRun]:
    """The engines' one-liner: None config -> None, else a ResilientRun
    keyed by `run_signature(engine, **sig_params)`."""
    if cfg is None:
        return None
    return ResilientRun(cfg, engine, run_signature(engine, **sig_params))


def metrics_restore(ms: list) -> list:
    """Finished per-job metrics out of the JSON payload.  Floats
    round-trip exactly (json emits repr-precision doubles); per-class
    list leaves (serving) come back as lists, matching the engine's own
    representation."""
    return [None if m is None else dict(m) for m in ms]


@dataclasses.dataclass
class RunProgress:
    """The host side of a fleet or serving run that a snapshot publishes
    beside the carry: finished per-job metrics, the global launch clock
    (the checkpoint step and the fault plane's clock, counted across
    groups), the fleet's launch-level slot savings, and the degraded jobs
    with their recovery plan."""

    metrics: list
    glaunch: int = 0
    launch_saved: int = 0
    degraded: Dict[int, str] = dataclasses.field(default_factory=dict)
    recovery: Optional[RecoveryPlan] = None

    @classmethod
    def start(cls, n_jobs: int, resumed: Optional[dict]) -> "RunProgress":
        """A fresh run's progress, or the resumed checkpoint's."""
        p = cls([None] * n_jobs)
        if resumed is not None:
            p.metrics = metrics_restore(resumed["metrics"])
            p.glaunch = resumed["global_launch"]
            p.launch_saved = resumed.get("launch_saved", 0)
            p.degraded = {int(k): v for k, v in resumed["degraded"].items()}
            p.recovery = plan_restore(resumed["recovery"])
        return p

    def extra(self, group: int, launched: int) -> dict:
        """The snapshot payload at this boundary: group ``group`` has run
        ``launched`` chunks."""
        return {"group": group, "launched": launched,
                "global_launch": self.glaunch, "metrics": self.metrics,
                "launch_saved": self.launch_saved,
                "degraded": {str(k): v for k, v in self.degraded.items()},
                "recovery": plan_state(self.recovery)}

    def drop_hosts(self, dead, idxs, ndev: int = 1) -> Optional[np.ndarray]:
        """Flag the jobs ``idxs`` of a group whose lanes sit on ``dead``
        hosts degraded and re-plan the mesh: the [B] mask of the dead
        hosts' lanes when it holds a job not flagged before, else None."""
        if not dead:
            return None
        B = len(idxs)
        lane_dead = host_lane_mask(B, ndev, dead)
        per = B // ndev
        fresh = [l for l in range(B)
                 if lane_dead[l] and idxs[l] not in self.degraded]
        for l in fresh:
            self.degraded[idxs[l]] = f"host_dropout:host{l // per}"
        self.recovery = plan_recovery(ndev, 1, [f"host{h}" for h in dead],
                                      [], 1)
        return lane_dead if fresh else None


def resume_group(rt: Optional[ResilientRun], g: int, launch, runner,
                 emitter, sink, n_sims: int, engine: str) -> int:
    """Pick up group ``g`` of a resumed fleet or serving run, after
    ``launch.start``: write the checkpoint's carry into ``launch.carry``,
    pin the emitter's clock to the restored probe, and mark the seam with
    one ``resume`` record.  Returns the chunks the group had run at the
    snapshot (0 when the run does not resume in this group)."""
    resumed = None if rt is None else rt.resumed
    if resumed is None or g != resumed["group"]:
        return 0
    launched = resumed["launched"]
    if launched > 0:
        rt.restore_carry(launch)
        if emitter is not None:
            emitter.restore_clock(launched, runner.probe(launch.carry))
    if sink is not None:
        sink.write(schema.make_record(
            "resume", group=g, chunk=launched, t=launched * runner.chunk,
            n_sims=n_sims, engine=engine, ckpt_step=resumed["ckpt_step"],
            n_preloaded=sink.n_preloaded))
    return launched
