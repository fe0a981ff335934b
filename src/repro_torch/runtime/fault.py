"""Fault tolerance: straggler detection, heartbeat tracking, elastic
re-mesh planning.

A copy of `repro.runtime.fault` (pure Python, so the port keeps its own).

At 1000+-node scale the failure model is: (i) slow hosts (thermal, network)
-> detect via per-step timing statistics and rebalance/evict; (ii) dead
hosts -> detect via heartbeat timeout -> rebuild a smaller mesh and restore
from the last checkpoint (full-array checkpoints re-shard onto any mesh,
checkpoint/checkpointer.py).  This module is pure control-plane logic so it
is unit-testable on one host; the launcher wires it to real timers.

The straggler policy is itself the paper's lesson: queue-length (backlog)
based decisions beat static assignment — a host whose step-time queue grows
is drained before it stalls the collective.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 32               # ring-buffer of recent step times
    factor: float = 1.8            # median multiple considered "straggling"
    patience: int = 8              # consecutive slow steps before action
    heartbeat_timeout_s: float = 60.0


class StragglerDetector:
    """Per-host step-time ring buffers + median-factor rule."""

    def __init__(self, hosts: List[str], cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.times: Dict[str, deque] = {h: deque(maxlen=cfg.window)
                                        for h in hosts}
        self.slow_streak: Dict[str, int] = {h: 0 for h in hosts}
        self.last_seen: Dict[str, float] = {h: time.time() for h in hosts}

    def record(self, host: str, step_time: float,
               now: Optional[float] = None) -> None:
        self.times[host].append(step_time)
        self.last_seen[host] = now if now is not None else time.time()

    def _medians(self) -> Dict[str, float]:
        meds = {}
        for h, buf in self.times.items():
            if buf:
                s = sorted(buf)
                meds[h] = s[len(s) // 2]
        return meds

    def stragglers(self) -> List[str]:
        """Hosts whose median step time exceeds factor x fleet median."""
        meds = self._medians()
        if len(meds) < 2:
            return []
        fleet = sorted(meds.values())[len(meds) // 2]
        out = []
        for h, m in meds.items():
            if m > self.cfg.factor * fleet:
                self.slow_streak[h] += 1
                if self.slow_streak[h] >= self.cfg.patience:
                    out.append(h)
            else:
                self.slow_streak[h] = 0
        return out

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items()
                if now - t > self.cfg.heartbeat_timeout_s]


# ---------------------------------------------------------------------------
# Injectable fault plane (DESIGN.md §12)
#
# The chunk schedulers (fleet/engine.py, fleet/atlas.py, serving/engine.py)
# consult a FaultPlane at two points of every launch:
#
#   * before dispatch   -> `on_launch` may raise InjectedFault (a transient
#     launch failure).  The carry has NOT been donated yet, so the engine
#     retries the same launch with the live carry, bounded by
#     ResilienceConfig.max_retries with exponential backoff; exhaustion
#     raises FaultExhausted.
#   * at the boundary   -> after the post-launch snapshot, `maybe_preempt`
#     may raise Preempted (a simulated SIGTERM).  The snapshot is already
#     durable, so a resumed run continues bit-exact from this boundary.
#     `dead_hosts` reports which mesh hosts have dropped out by this
#     boundary; the engines park their lanes and re-plan via
#     `plan_recovery` instead of aborting.
#
# The plane is pure host-side state: deterministic, unit-testable, and
# shared across the retries of one run (a `fails=2` spec fails twice total,
# not twice per attempt).


class InjectedFault(RuntimeError):
    """A (simulated) transient launch failure — retryable."""


class FaultExhausted(RuntimeError):
    """A launch kept failing past ResilienceConfig.max_retries."""


class Preempted(RuntimeError):
    """A (simulated) SIGTERM at a chunk boundary.  The engine's snapshot
    for this boundary is already on disk when this propagates."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    kind       : "launch_fail" | "host_dropout" | "preempt"
    at_launch  : global launch index (0-based, counted across policy
                 groups).  launch_fail fires when launch `at_launch` is
                 dispatched; host_dropout means the host is dead for every
                 boundary >= at_launch; preempt fires at the boundary after
                 `at_launch` launches have completed.
    group      : restrict launch_fail to one policy group (None = any).
    fails      : launch_fail only — how many consecutive attempts fail
                 before the retry succeeds.
    host       : host_dropout only — mesh host index that dies.
    """
    kind: str
    at_launch: int = 0
    group: Optional[int] = None
    fails: int = 1
    host: int = 0


class FaultPlane:
    """Deterministic fault schedule consumed by the chunk schedulers."""

    def __init__(self, specs: tuple | list = ()):
        self.specs: List[FaultSpec] = list(specs)
        for s in self.specs:
            assert s.kind in ("launch_fail", "host_dropout", "preempt"), s
        self._fails_left = {i: s.fails for i, s in enumerate(self.specs)
                            if s.kind == "launch_fail"}
        self.n_injected = 0
        self.log: List[tuple] = []     # (event, launch_idx, detail)

    # -- convenience constructors ------------------------------------------
    @classmethod
    def preempt_after(cls, n_launches: int) -> "FaultPlane":
        """Simulate SIGTERM at the boundary after `n_launches` launches."""
        return cls([FaultSpec("preempt", at_launch=n_launches)])

    @classmethod
    def launch_fail(cls, at_launch: int, fails: int = 1,
                    group: Optional[int] = None) -> "FaultPlane":
        return cls([FaultSpec("launch_fail", at_launch=at_launch,
                              fails=fails, group=group)])

    @classmethod
    def host_dropout(cls, host: int, at_launch: int) -> "FaultPlane":
        """Host `host` drops out at boundary `at_launch` (and stays dead)."""
        return cls([FaultSpec("host_dropout", at_launch=at_launch,
                              host=host)])

    # -- scheduler hooks ---------------------------------------------------
    def on_launch(self, group: int, launch_idx: int) -> None:
        """Raise InjectedFault if a launch_fail spec targets this attempt."""
        for i, s in enumerate(self.specs):
            if (s.kind == "launch_fail" and s.at_launch == launch_idx
                    and (s.group is None or s.group == group)
                    and self._fails_left.get(i, 0) > 0):
                self._fails_left[i] -= 1
                self.n_injected += 1
                self.log.append(("launch_fail", launch_idx, group))
                raise InjectedFault(
                    f"injected launch failure at launch {launch_idx} "
                    f"(group {group})")

    def maybe_preempt(self, launches_done: int) -> None:
        """Raise Preempted at the boundary after `launches_done` launches."""
        for s in self.specs:
            if s.kind == "preempt" and s.at_launch == launches_done:
                self.log.append(("preempt", launches_done, None))
                raise Preempted(
                    f"simulated SIGTERM after {launches_done} launches")

    def dead_hosts(self, launches_done: int) -> tuple:
        """Sorted mesh-host indices dead at this boundary."""
        return tuple(sorted({s.host for s in self.specs
                             if s.kind == "host_dropout"
                             and s.at_launch <= launches_done}))


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    action: str                    # none | rebalance | remesh
    evict: tuple = ()
    new_mesh_shape: Optional[tuple] = None
    note: str = ""


def plan_recovery(n_hosts: int, devices_per_host: int, dead: List[str],
                  stragglers: List[str], model_parallel: int) -> RecoveryPlan:
    """Decide the cheapest recovery that keeps the mesh factorizable.

    Policy: dead hosts force a re-mesh (drop to the largest device count
    divisible by model_parallel); stragglers are first rebalanced (smaller
    per-host batch via the backpressure admission queue), evicted only if
    they persist.
    """
    if dead:
        alive = n_hosts - len(dead)
        devices = alive * devices_per_host
        dp = devices // model_parallel
        if dp < 1:
            return RecoveryPlan("remesh", tuple(dead), None,
                                "not enough devices for model parallelism")
        return RecoveryPlan("remesh", tuple(dead),
                            (dp, model_parallel),
                            f"rebuild ({dp},{model_parallel}) mesh, restore "
                            "latest checkpoint with resharding")
    if stragglers:
        return RecoveryPlan("rebalance", tuple(stragglers), None,
                            "shift admission quota away from stragglers "
                            "(H-queue weighting), evict on next strike")
    return RecoveryPlan("none")
