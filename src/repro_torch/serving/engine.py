"""Serving engine: batched trace-driven runs on the fleet substrate.

Port of `repro.serving.engine`.  `run_serving` is the serving twin of
`fleet.run_fleet`: jobs are grouped by (the fleet's policy group key,
trace), the axes that change the slot's control flow, padded to common
dims, and each group runs as one batch through a `fleet.engine.
GroupLaunch` (on CUDA, replays of one captured graph of 64 slots).  The
scenario's event model is per-sim data as in the fleet; its arrival model
is replaced by the job's `TraceSpec`.

Between chunks the carry's probe (cumulative delivered, admitted and shed
mass, gate, verdict, the latency histogram) goes through the telemetry
plane (`repro_torch.obs.emitter`), which differences consecutive probes
into windowed per-chunk records (delivered QPS, shed fraction, p99
sojourn, verdict counts, each a median across the group's sims),
validated against the versioned stream schema.  With ``stream=True``
they land in `ServingResult.stream_records`, one per chunk per group.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.queues import VERDICT_NAMES
from repro_torch.device import resolve_device
from repro_torch.fleet.batching import PadDims, from_leaves, pad_leaves
from repro_torch.fleet.engine import (VerdictConfig, _policy_group_key,
                                      launch_for)
from repro_torch.fleet.scenarios import event_code, get_scenario
from repro_torch.obs.emitter import ChunkEmitter, open_sink
from .admission import AdmissionConfig
from .scheduler import make_serving_runner
from .trace import get_trace


@dataclasses.dataclass(frozen=True)
class ServingJob:
    """One serving run: a scenario instance facing a live query trace."""

    scenario: str = "paper_grid"
    policy: str = "pi3_reg"
    trace: str = "bursty"
    lam: float = 1.0              # long-run offered QPS across all classes
    seed: int = 0
    topo_seed: int = 0
    eps_b: float = 0.05
    pairing: str = "fifo"
    threshold: float = 0.0
    fixed_node: int = 0

    def policy_config(self) -> PolicyConfig:
        return PolicyConfig(
            name=self.policy, eps_b=self.eps_b, pairing=self.pairing,
            threshold=self.threshold, fixed_node=self.fixed_node,
            wireless=get_scenario(self.scenario).wireless)


@dataclasses.dataclass
class ServingResult:
    jobs: List[ServingJob]
    metrics: List[Dict[str, float]]   # one dict per job, same order;
                                      # per-class leaves are lists of floats
    n_programs: int                   # (policy group x trace) batches
    n_sims: int
    dims: PadDims
    T: int
    window: int
    stream_records: List[dict] = dataclasses.field(default_factory=list)
    slot_steps: int = 0           # batched slot steps run, over all groups
    device: str = ""
    n_step_compiles: int = 0      # graph captures on CUDA, launchers on the
                                  # CPU (cumulative per launcher)
    resumed_from: int | None = None   # checkpoint step this run restored
                                      # (`runtime.resilience`); None = fresh
    degraded: Dict[int, str] = dataclasses.field(default_factory=dict)
                                  # job index -> why it is flagged
    recovery_plan: object | None = None   # runtime.fault.RecoveryPlan
    n_fault_retries: int = 0      # injected launch failures retried

    def column(self, name: str) -> np.ndarray:
        return np.array([m[name] for m in self.metrics])

    def verdicts(self) -> List[str]:
        return [VERDICT_NAMES[int(m["verdict"])] for m in self.metrics]


def metric_rows(out: Dict) -> List[Dict[str, float]]:
    """`ServingRunner.finalize`'s tensors as one row per sim: floats, and
    lists of floats for the per-class leaves."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    n = len(next(iter(host.values())))
    return [{k: (float(v[j]) if v.ndim == 1 else v[j].astype(float).tolist())
             for k, v in host.items()} for j in range(n)]


def _group_key(job: ServingJob):
    """Batch-forking axes: the fleet's policy key and the trace (the class
    mixture is host-level structure of the slot)."""
    return (_policy_group_key(job), job.trace)


def run_serving(jobs: Sequence[ServingJob], T: int, chunk: int = 512,
                window: int | None = None, device=None,
                dims: PadDims | None = None,
                verdict: VerdictConfig | None = None,
                admission: AdmissionConfig | None = None,
                stream: bool = False,
                stream_log: Callable[[dict], None] | None = None,
                stream_path: str | None = None,
                resilience=None) -> ServingResult:
    """Run every serving job on ``device`` (CUDA unless the caller asks for
    the CPU), one batch per (policy group, trace), with per-chunk stream
    records when ``stream`` is on.

    ``stream_log``/``stream_path`` (each implies ``stream``) mirror
    `fleet.run_fleet`: records are assembled off the host loop on the
    emitter's worker thread, ``stream_log`` is called there, and
    ``stream_path`` appends JSONL live.

    ``resilience`` mirrors `fleet.run_fleet`: snapshots of the carry (the
    admission state, the latency ring and histogram and the trace cursor
    ride in it) at chunk boundaries, bit-exact resume into the launch's
    tensors, retry with backoff on injected launch failures.  A host
    dropout only flags the affected jobs (``ServingResult.degraded``) and
    plans recovery, as in the reference: serving parks no lane."""
    from repro_torch.runtime.resilience import (RunProgress,
                                                maybe_resilient,
                                                resume_group)
    dev = resolve_device(device)
    jobs = list(jobs)
    problem_of: Dict[tuple, ComputeProblem] = {}
    for job in jobs:
        k = (job.scenario, job.topo_seed)
        if k not in problem_of:
            problem_of[k] = get_scenario(job.scenario).build(job.topo_seed)
    dims = dims or PadDims.of(list(problem_of.values()))
    leaves_of = {k: pad_leaves(p, dims) for k, p in problem_of.items()}

    groups: Dict[tuple, List[int]] = {}
    for i, job in enumerate(jobs):
        groups.setdefault(_group_key(job), []).append(i)

    rt = maybe_resilient(resilience, "serving", jobs=tuple(jobs), T=T,
                         chunk=chunk, window=window, verdict=verdict,
                         admission=admission, dims=dims, ndev=1)
    resumed = rt.resumed if rt is not None else None
    prog = RunProgress.start(len(jobs), resumed)
    eff_T = eff_win = slot_steps = n_compiles = 0
    sink = open_sink(stream, stream_log, stream_path,
                     append=resumed is not None)
    try:
        for g, idxs in enumerate(groups.values()):
            group = [jobs[i] for i in idxs]
            runner = make_serving_runner(
                group[0].policy_config(), get_trace(group[0].trace), T,
                chunk=chunk, window=window, verdict=verdict,
                admission=admission)
            eff_T, eff_win = runner.T, runner.window
            if resumed is not None and g < resumed["group"]:
                continue          # finished before the kill: metrics restored
            pp = from_leaves([leaves_of[(j.scenario, j.topo_seed)]
                              for j in group], dims.n_nodes, dims.n_comp,
                             dev)
            inp = runner.make_inputs(
                pp, [j.lam for j in group], [j.eps_b for j in group],
                [event_code(get_scenario(j.scenario).events) for j in group],
                [j.seed for j in group])
            launch = launch_for(runner, inp)
            launch.start(inp)
            emitter = (ChunkEmitter("serving", g, len(group), runner, sink)
                       if sink is not None else None)
            try:
                launched = first = resume_group(rt, g, launch, runner,
                                                emitter, sink, len(group),
                                                "serving")
                while launched < runner.n_chunks:
                    if rt is not None:
                        rt.launch(g, prog.glaunch, launch.step)
                    else:
                        launch.step()
                    launched += 1
                    prog.glaunch += 1
                    if emitter is not None:
                        emitter.emit(runner.probe(launch.carry))
                    if rt is not None:
                        prog.drop_hosts(rt.dead_hosts(prog.glaunch), idxs)
                        if rt.should_snapshot(prog.glaunch):
                            rt.snapshot(prog.glaunch, launch.carry,
                                        prog.extra(g, launched))
                        rt.maybe_preempt(prog.glaunch)
            finally:
                if emitter is not None:
                    emitter.close()
            slot_steps += (launched - first) * runner.chunk
            n_compiles += launch.n_compiles
            rows = metric_rows(runner.finalize(launch.inp, launch.carry))
            for j, i in enumerate(idxs):
                prog.metrics[i] = rows[j]
            if rt is not None:
                rt.snapshot(prog.glaunch, (), prog.extra(g + 1, 0))
    finally:
        if sink is not None:
            sink.close()
        if rt is not None:
            rt.wait()
    return ServingResult(jobs=jobs, metrics=prog.metrics,
                         n_programs=len(groups), n_sims=len(jobs), dims=dims,
                         T=eff_T, window=eff_win,
                         stream_records=(sink.records if sink is not None
                                         else []),
                         slot_steps=slot_steps, device=str(dev),
                         n_step_compiles=n_compiles,
                         resumed_from=(resumed["ckpt_step"]
                                       if resumed is not None else None),
                         degraded=prog.degraded,
                         recovery_plan=prog.recovery,
                         n_fault_retries=(rt.n_retries if rt is not None
                                          else 0))
