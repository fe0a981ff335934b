"""Capacity atlas: a fleet of λ_max bisections in one batch per group.

Port of `repro.fleet.atlas`.  `frontier.find_lambda_max` bisects one
(scenario, topo_seed) cell at a time, every probe its own `run_fleet`
call.  The atlas runs hundreds of (cell x seed) bisection lanes in **one
padded batch per (policy group x size bucket)**, each lane probing its own
cell's current grid rate: the offered rate is per-sim data of the chunk
step.  Size buckets (`batching.make_buckets`) keep one big topology from
inflating every small lane's padding; ``max_requeues`` re-runs cells whose
search ended UNDECIDED at the top, or collapsed, at a doubled horizon.

The host loop, per batch:

  1. every cell owns a `frontier.Bisection` machine (the machine the
     sequential path drives), and its ``len(seeds)`` lanes run the
     machine's pending grid rate;
  2. after each chunk (one `GroupLaunch.step`, on CUDA replays of one
     captured graph) the host reads the [B] verdict and decision-slot
     leaves and harvests every cell whose probe finished: all its lanes
     decided (early stop) or the horizon's chunks elapsed;
  3. harvested cells record into their machine, pull the next probe, and
     get their lanes rewritten in place (`engine.make_sim_rewriter`):
     fresh carry, t = 0, seed `fold_seed(topo_seed, rate_index, attempt,
     seed)`, the new rate and its Poisson row, the state a standalone
     `run_fleet` probe starts from;
  4. cells whose machine finishes are parked: their verdict leaf is forced
     UNSTABLE so the freeze pins their lanes while the rest bisect on.

Lanes never interact (the port's noise is per sim and per slot, and each
Poisson row depends on its own rate only), and untouched lanes pass a
rewrite bit-unchanged, so each cell's row is bit-identical to per-cell
`find_lambda_max` at the same `PadDims` on the same device.

With ``resilience`` every boundary's snapshot holds the carry and the
scheduler's state (`_atlas_extra`); a resumed sweep rebuilds the batch's
inputs from the snapshot's lane tables and writes the carry into the
launch's tensors, so its rows are the uninterrupted sweep's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import ComputeProblem
from repro_torch.core.queues import VERDICT_NAMES, VERDICT_UNDECIDED
from repro_torch.device import resolve_device
from repro_torch.obs import schema
from repro_torch.obs.emitter import atlas_record, open_sink
from .batching import PadDims, from_leaves, make_buckets, pad_leaves
from .engine import (FleetJob, VerdictConfig, _policy_group_key, launch_for,
                     make_inputs, make_sim_rewriter, make_stream_runner,
                     resolve_verdict)
from .frontier import Bisection, RateProbe, bracket_indices, fold_seed
from .report import policy_bound_exact
from .scenarios import arrival_code, event_code, get_scenario


@dataclasses.dataclass(frozen=True)
class AtlasJob:
    """One cell of the capacity atlas: a (scenario, topo_seed) instance
    whose λ_max is bisected against its own exact LP bound."""

    scenario: str
    policy: str = "pi3"
    topo_seed: int = 0
    eps_b: float = 0.01


@dataclasses.dataclass(frozen=True)
class AtlasRow:
    """One cell's finished frontier search (the atlas analog of
    `frontier.FrontierResult`, without the per-search launch accounting)."""

    scenario: str
    policy: str
    eps_b: float
    topo_seed: int
    lam_max: float           # largest grid rate verified sustainable
    bound_exact: float       # the exact regulated LP bound of this cell
    ratio: float             # lam_max / bound_exact
    lo: float                # final bracket: sustainable side
    hi: float                # final bracket: unsustainable side
    n_calls: int             # probes evaluated for this cell
    n_iters: int             # bisection halvings
    undecided: bool          # hi never proven unstable (UNDECIDED only)
    hi_certain: float | None  # smallest rate with genuine UNSTABLE evidence
    total_slots: int         # simulated slots advanced across the probes
    full_slots: int          # slots a freeze-free search would have run
    slots_saved: int         # full_slots - total_slots
    probes: Tuple[RateProbe, ...]
    degraded: bool = False   # the cell's lanes sat on a dropped host: the
                             # search was cut short and (lo, hi) is the
                             # bracket at the dropout
    bucket: int = 0          # PadDims bucket the cell's lanes ran in
    n_requeues: int = 0      # adaptive-horizon escalations: each restarted
                             # the search at double the horizon with a
                             # bumped fold_seed call_index


@dataclasses.dataclass
class AtlasResult:
    """The whole atlas: per-cell rows and batch-level launch accounting."""

    rows: List[AtlasRow]
    n_cells: int
    n_lanes: int             # (cell x seed) bisection lanes advanced
    n_programs: int          # (policy group x bucket) batches, each its
                             # own padded shape and chunk program
    n_launches: int          # chunks the atlas ran
    seq_launches: int        # chunks per-cell find_lambda_max would run
    n_rewrites: int          # in-place carry rewrites between chunks
    n_step_compiles: int     # chunk programs of the batches' launchers:
                             # graph captures on CUDA, launchers on the
                             # CPU (cumulative per launcher)
    total_slots: int
    full_slots: int
    slots_saved: int
    launch_slots_saved: int  # sequential-semantics launch savings
    dims: PadDims
    T: int
    chunk: int
    bucket_dims: List[PadDims] = dataclasses.field(default_factory=list)
    bucket_cells: Dict[int, int] = dataclasses.field(default_factory=dict)
    bucket_launches: Dict[int, int] = dataclasses.field(default_factory=dict)
    n_requeues: int = 0      # adaptive-horizon re-queues across cells
    slot_steps: int = 0      # batched slot steps run, over all batches
    device: str = ""
    stream_records: List[dict] = dataclasses.field(default_factory=list)
                             # one atlas record per launch
                             # (sweep_lambda_max(stream=True))
    resumed_from: int | None = None   # checkpoint step this sweep restored
                                      # (`runtime.resilience`); None = fresh
    degraded: Dict[int, str] = dataclasses.field(default_factory=dict)
                             # cell index -> reason for cells parked by a
                             # host dropout (their rows carry degraded=True)
    recovery_plan: object | None = None   # runtime.fault.RecoveryPlan
    n_fault_retries: int = 0

    @property
    def n_buckets(self) -> int:
        return max(len(self.bucket_dims), 1)

    @property
    def launch_speedup(self) -> float:
        """How many sequential chunks one atlas chunk replaced."""
        return self.seq_launches / self.n_launches if self.n_launches else 0.0


def registry_cells(families: Sequence[str], topo_seeds: Sequence[int],
                   policy: str = "pi3", eps_b: float = 0.01
                   ) -> List[AtlasJob]:
    """The (family x topo_seed) atlas grid as `AtlasJob` cells."""
    return [AtlasJob(scenario=f, policy=policy, topo_seed=int(ts),
                     eps_b=eps_b)
            for f in families for ts in topo_seeds]


def sweep_lambda_max(cells: Sequence[AtlasJob], *,
                     seeds: Sequence[int] = (0,), T: int = 4096,
                     chunk: int = 512, window: int | None = None,
                     rel_tol: float = 0.025,
                     bracket: Tuple[float, float] = (0.5, 1.1),
                     max_calls: int = 24, early_stop: bool = True,
                     verdict: VerdictConfig | None = None,
                     device=None, dims: PadDims | None = None,
                     n_buckets: int = 1,
                     max_requeues: int = 0,
                     stream: bool = False, stream_log=None,
                     stream_path: str | None = None,
                     resilience=None) -> AtlasResult:
    """Bisect λ_max for every atlas cell on ``device`` (CUDA unless the
    caller asks for the CPU), one padded batch per (policy group x size
    bucket) advancing all of its cells' current probes at once.

    Parameters mirror `find_lambda_max`: each cell's search is driven by
    the same `Bisection` machine on the ``rel_tol`` grid of its own exact
    bound, with the same `fold_seed` probe seeds, so each row is
    bit-identical to the sequential path run at the cell's bucket dims
    (`AtlasResult.bucket_dims[row.bucket]`).  ``early_stop=True`` harvests
    a probe as soon as all its lanes latch; ``False`` runs every probe for
    the whole horizon.  ``n_buckets > 1`` cuts size buckets
    (`batching.make_buckets`); an explicit ``dims`` forces one bucket
    padded to it.  ``max_requeues > 0`` restarts a cell whose finished
    search is UNDECIDED at its top, or collapsed (``k_lo == 0``), from its
    first bracket with double the chunk budget, up to ``max_requeues``
    times, its fold_seed ``call_index`` bumped to the attempt number.

    ``stream``/``stream_log``/``stream_path`` mirror `run_fleet`: one
    atlas record per launch (bisection progress per family, from the host
    scheduler's state, so streaming cannot perturb the bisections), in
    ``AtlasResult.stream_records``; the stream clock ``t`` counts slots
    dispatched per lane.

    ``resilience`` makes the sweep preemption-safe: every launch boundary
    snapshots the carry and the host scheduler (each cell's serialized
    `Bisection` machine, `RateProbe` history, pending assignments and
    attempt counters, the lane tables of offered rates, seeds and parked
    lanes, the bucket cursor and the launch counters), so a killed sweep
    resumes with bit-identical brackets, rows and stream records: the
    batch's inputs are rebuilt from the lane tables and the carry written
    into the launch's tensors.  A host dropout parks the affected cells'
    lanes and finishes their rows from the current bracket with
    ``degraded=True`` (reported in ``AtlasResult.degraded``)."""
    cells = list(cells)
    if not cells:
        raise ValueError("empty atlas")
    dev = resolve_device(device)
    return _sweep(cells, dev, tuple(seeds), T, chunk, window, rel_tol,
                  bracket, max_calls, early_stop, verdict, dims, n_buckets,
                  max_requeues, stream, stream_log, stream_path, resilience)


def _sweep(cells, dev, seeds, T, chunk, window, rel_tol, bracket, max_calls,
           early_stop, verdict, dims, n_buckets, max_requeues, stream,
           stream_log, stream_path, resilience) -> AtlasResult:
    """`sweep_lambda_max`'s batches, each to its end."""
    from repro_torch.runtime import resilience as rz
    vcfg = resolve_verdict(verdict, early_stop)
    S = len(seeds)

    # Per-cell bound, grid step and bisection machine, with the bracket
    # arithmetic of find_lambda_max.
    bounds: List[float] = []
    steps: List[float] = []
    machines: List[Bisection] = []
    k0: List[Tuple[int, int]] = []
    for c in cells:
        bound = policy_bound_exact(c.scenario, c.policy, c.eps_b,
                                   topo_seed=c.topo_seed)
        if bound <= 0.0:
            raise ValueError(f"{c.scenario}: exact LP bound is {bound}; "
                             "nothing to bisect")
        step = rel_tol * bound
        bounds.append(bound)
        steps.append(step)
        k0.append(bracket_indices(bound, step, bracket))
        machines.append(Bisection(*k0[-1], max_calls=max_calls))

    # Topologies: each distinct one built once, padded to its bucket.
    problem_of: Dict[tuple, ComputeProblem] = {}
    for c in cells:
        k = (c.scenario, c.topo_seed)
        if k not in problem_of:
            problem_of[k] = get_scenario(c.scenario).build(c.topo_seed)
    problem_keys = list(problem_of)
    if dims is not None:
        bucket_dims = [dims]
        bucket_of = {k: 0 for k in problem_keys}
    else:
        bucket_dims, assignment = make_buckets(
            [problem_of[k] for k in problem_keys], n_buckets)
        bucket_of = {k: b for k, b in zip(problem_keys, assignment)}
    dims = PadDims(
        n_nodes=max(d.n_nodes for d in bucket_dims),
        n_edges=max(d.n_edges for d in bucket_dims),
        n_comp=max(d.n_comp for d in bucket_dims))
    leaves_of = {k: pad_leaves(p, bucket_dims[bucket_of[k]])
                 for k, p in problem_of.items()}
    cell_bucket = [bucket_of[(c.scenario, c.topo_seed)] for c in cells]

    # Batches: policy groups (the axis that forks control flow) x buckets,
    # groups in insertion order, buckets ascending.
    groups: Dict[tuple, List[int]] = {}
    for ci, c in enumerate(cells):
        key = _policy_group_key(FleetJob(scenario=c.scenario,
                                         policy=c.policy, eps_b=c.eps_b,
                                         topo_seed=c.topo_seed))
        groups.setdefault(key, []).append(ci)
    units: List[Tuple[int, List[int]]] = []
    for cidx_g in groups.values():
        by_bucket: Dict[int, List[int]] = {}
        for ci in cidx_g:
            by_bucket.setdefault(cell_bucket[ci], []).append(ci)
        units += [(b, by_bucket[b]) for b in sorted(by_bucket)]

    rt = rz.maybe_resilient(resilience, "atlas", cells=tuple(cells),
                            seeds=seeds, T=T, chunk=chunk, window=window,
                            rel_tol=rel_tol, bracket=tuple(bracket),
                            max_calls=max_calls, early_stop=early_stop,
                            verdict=vcfg, dims=tuple(bucket_dims),
                            n_buckets=n_buckets, max_requeues=max_requeues,
                            ndev=1)
    resumed = rt.resumed if rt is not None else None

    rows: List[AtlasRow | None] = [None] * len(cells)
    attempt: List[int] = [0] * len(cells)
    n_launches = seq_launches = n_rewrites = launch_slots_saved = 0
    n_step_compiles = n_requeues = slot_steps = 0
    bucket_launches: Dict[int, int] = {b: 0 for b in range(len(bucket_dims))}
    degraded: Dict[int, str] = {}
    recovery = None
    eff_T = eff_chunk = 0
    if resumed is not None:
        # The host scheduler as the snapshot left it: every cell's machine
        # (finished units' in their final state, unstarted ones' in their
        # first), finished rows, attempt counters, launch counters.
        for ci_s, ms in resumed["machines"].items():
            machines[int(ci_s)] = Bisection.from_state(ms)
        for ci_s, rs in resumed["rows"].items():
            rows[int(ci_s)] = rz.row_restore(rs)
        for ci_s, a in resumed["attempt"].items():
            attempt[int(ci_s)] = int(a)
        n_launches = resumed["n_launches"]
        seq_launches = resumed["seq_launches"]
        n_rewrites = resumed["n_rewrites"]
        launch_slots_saved = resumed["launch_slots_saved"]
        n_step_compiles = resumed["n_step_compiles"]
        n_requeues = resumed["n_requeues"]
        bucket_launches.update(
            {int(b): int(n) for b, n in resumed["bucket_launches"].items()})
        degraded = {int(k): v for k, v in resumed["degraded"].items()}
        recovery = rz.plan_restore(resumed["recovery"])
    sink = open_sink(stream, stream_log, stream_path,
                     append=resumed is not None)
    try:
        for g, (bkt, cidx) in enumerate(units):
            c0 = cells[cidx[0]]
            cfg = FleetJob(scenario=c0.scenario, policy=c0.policy,
                           eps_b=c0.eps_b,
                           topo_seed=c0.topo_seed).policy_config()
            runner = make_stream_runner(cfg, T, chunk=chunk, window=window,
                                        verdict=vcfg)
            eff_T, eff_chunk = runner.T, runner.chunk
            n_chunks = runner.n_chunks
            if resumed is not None and g < resumed["group"]:
                continue          # finished before the kill: rows restored

            # Lane layout: S contiguous lanes per cell.
            lane_cells = [ci for ci in cidx for _ in seeds]
            B = len(lane_cells)
            lane_of = {ci: slice(j * S, (j + 1) * S)
                       for j, ci in enumerate(cidx)}
            scen = [get_scenario(cells[ci].scenario) for ci in lane_cells]

            pending: Dict[int, int] = {}
            chunks_used: Dict[int, int] = {}
            probes_of: Dict[int, List[RateProbe]] = {ci: [] for ci in cidx}
            lam_host = np.zeros(B, np.float32)
            seed_host = np.zeros(B, np.int64)
            active: set = set()

            def _assign(ci: int, k: int) -> None:
                # call_index = attempt: first attempts replay the sequential
                # fold_seed stream, re-queued ones draw fresh noise.
                pending[ci] = k
                chunks_used[ci] = 0
                sl = lane_of[ci]
                lam_host[sl] = np.float32(k * steps[ci])
                seed_host[sl] = [fold_seed(cells[ci].topo_seed, k,
                                           attempt[ci], s) for s in seeds]

            def _parked() -> np.ndarray:
                park = np.zeros(B, bool)
                for ci in cidx:
                    park[lane_of[ci]] = ci not in active
                return park

            resume_here = resumed is not None and g == resumed["group"]
            restore = resume_here and resumed["g_launches"] > 0
            park0 = np.zeros(B, bool)
            if restore:
                # Mid-batch: the lane tables and pending probes as the
                # killed sweep left them; the inputs are rebuilt from them.
                pending = {int(k): v for k, v in resumed["pending"].items()}
                chunks_used = {int(k): v
                               for k, v in resumed["chunks_used"].items()}
                for ci_s, ps in resumed["probes"].items():
                    probes_of[int(ci_s)] = [rz.probe_restore(p) for p in ps]
                lam_host = np.array(resumed["lam_host"], np.float32)
                seed_host = np.array(resumed["seed_host"], np.int64)
                active = set(resumed["active"])
                g_launches = resumed["g_launches"]
            else:
                for ci in cidx:
                    k = machines[ci].next_rate_index()
                    if k is None:       # degenerate budget: probe-free
                        rows[ci] = _finish_row(cells[ci], bounds[ci],
                                               steps[ci], machines[ci], [],
                                               bucket=bkt)
                        park0[lane_of[ci]] = True
                    else:
                        active.add(ci)
                        _assign(ci, k)
                g_launches = 0

            pp = from_leaves([leaves_of[(cells[ci].scenario,
                                         cells[ci].topo_seed)]
                              for ci in lane_cells],
                             bucket_dims[bkt].n_nodes,
                             bucket_dims[bkt].n_comp, dev)
            inp = make_inputs(pp, lam_host,
                              [cells[ci].eps_b for ci in lane_cells],
                              [arrival_code(s.arrival) for s in scen],
                              [event_code(s.events) for s in scen],
                              seed_host)
            launch = launch_for(runner, inp)
            launch.start(inp, max_rate=max(max(k0[ci][0] + 1, k0[ci][1])
                                           * steps[ci] for ci in cidx))
            rewrite = make_sim_rewriter(launch)
            if restore:
                # The parked lanes' verdicts ride in the carry.
                rt.restore_carry(launch)
            elif park0.any():
                rewrite(np.zeros(B, bool), park0)
                n_rewrites += 1
            if sink is not None and resume_here:
                sink.write(schema.make_record(
                    "resume", group=g, chunk=g_launches,
                    t=g_launches * runner.chunk, n_sims=B, engine="atlas",
                    ckpt_step=resumed["ckpt_step"],
                    n_preloaded=sink.n_preloaded))

            while active:
                if rt is not None:
                    rt.launch(g, n_launches, launch.step)
                else:
                    launch.step()
                n_launches += 1
                g_launches += 1
                slot_steps += runner.chunk
                bucket_launches[bkt] += 1
                for ci in active:
                    chunks_used[ci] += 1

                # Between-chunk readout: the two [B] drift leaves only.
                verdicts = launch.carry.drift.verdict.cpu().numpy()
                decided_at = launch.carry.drift.decided_at.cpu().numpy()

                reset = np.zeros(B, bool)
                park = np.zeros(B, bool)
                changed = False
                dead = rt.dead_hosts(n_launches) if rt is not None else ()
                if dead:
                    # Graceful degradation: park every active cell with a
                    # lane on a dead host, finish its row from the bracket
                    # at the dropout (degraded=True), and re-plan.
                    lane_dead = rz.host_lane_mask(B, 1, dead)
                    for ci in sorted(active):
                        sl = lane_of[ci]
                        if lane_dead[sl].any():
                            active.discard(ci)
                            park[sl] = True
                            rows[ci] = _finish_row(
                                cells[ci], bounds[ci], steps[ci],
                                machines[ci], probes_of[ci], degraded=True,
                                bucket=bkt, n_requeues=attempt[ci])
                            # one device: every lane is host 0's
                            degraded[ci] = "host_dropout:host0"
                            changed = True
                    recovery = rz.plan_recovery(
                        1, 1, [f"host{h}" for h in dead], [], 1)
                for ci in sorted(active):
                    sl = lane_of[ci]
                    v = verdicts[sl]
                    # Adaptive horizon: attempt a probes up to
                    # n_chunks << a chunks of the same program.
                    horizon = n_chunks << attempt[ci]
                    finished = chunks_used[ci] >= horizon or (
                        early_stop and bool(np.all(v != VERDICT_UNDECIDED)))
                    if not finished:
                        continue
                    # Harvest: the RateProbe the sequential path would
                    # build from run_fleet's metrics.
                    k = pending[ci]
                    cell_T = runner.T << attempt[ci]
                    names = tuple(VERDICT_NAMES[int(x)] for x in v)
                    sustainable = all(n == "STABLE" for n in names)
                    d_eff = np.where(v != VERDICT_UNDECIDED, decided_at[sl],
                                     cell_T)
                    saved = (int(np.sum(cell_T - d_eff)) if vcfg.freeze
                             else 0)
                    probes_of[ci].append(RateProbe(
                        rate_index=k, call_index=attempt[ci],
                        lam=k * steps[ci],
                        sustainable=sustainable, verdicts=names,
                        decided_at=tuple(int(x) for x in d_eff),
                        slots_run=S * cell_T - saved, slots_saved=saved,
                        undecided=not sustainable
                        and "UNSTABLE" not in names))
                    seq_launches += chunks_used[ci]
                    launch_slots_saved += \
                        S * (horizon - chunks_used[ci]) * runner.chunk
                    machines[ci].record(k, sustainable,
                                        probes_of[ci][-1].undecided)
                    k2 = machines[ci].next_rate_index()
                    if k2 is None and (machines[ci].undecided_hi
                                       or machines[ci].k_lo == 0) \
                            and attempt[ci] < max_requeues:
                        # Re-queue: the bracket top is blocked by UNDECIDED
                        # evidence only, or the bracket collapsed (at rates
                        # far below capacity a slow gradient fill can read
                        # as UNSTABLE).  Restart from the first bracket
                        # with a doubled chunk budget and a bumped
                        # call_index.
                        attempt[ci] += 1
                        n_requeues += 1
                        machines[ci] = Bisection(*k0[ci],
                                                 max_calls=max_calls)
                        k2 = machines[ci].next_rate_index()
                    if k2 is None:
                        active.discard(ci)
                        park[sl] = True
                        rows[ci] = _finish_row(cells[ci], bounds[ci],
                                               steps[ci], machines[ci],
                                               probes_of[ci], bucket=bkt,
                                               n_requeues=attempt[ci])
                    else:
                        reset[sl] = True
                        _assign(ci, k2)
                    changed = True
                if changed and active:
                    # No rewrite once the batch drains: nothing runs again.
                    rewrite(reset, park, lam_host, seed_host)
                    n_rewrites += 1
                if sink is not None:
                    sink.write(atlas_record(
                        g, bkt, n_requeues, g_launches, runner.chunk, B,
                        cells, cidx, active, machines, steps, bounds,
                        probes_of, verdicts))
                if rt is not None:
                    if rt.should_snapshot(n_launches):
                        rt.snapshot(n_launches, launch.carry, _atlas_extra(
                            g, g_launches, n_launches, seq_launches,
                            n_rewrites, launch_slots_saved, n_step_compiles,
                            machines, rows, pending, chunks_used, probes_of,
                            cidx, lam_host, seed_host, _parked(), active,
                            degraded, recovery, attempt, n_requeues,
                            bucket_launches))
                    # After the snapshot: a preemption here leaves a
                    # durable, bit-exact resume point.
                    rt.maybe_preempt(n_launches)
            n_step_compiles += launch.n_compiles
            if rt is not None and rt.should_snapshot(n_launches):
                # Batch-end marker: empty carry, cursor at the next batch's
                # start; a resume here re-enters the fresh path with the
                # restored machines pulling the same grid.
                rt.snapshot(n_launches, (), _atlas_extra(
                    g + 1, 0, n_launches, seq_launches, n_rewrites,
                    launch_slots_saved, n_step_compiles, machines, rows,
                    {}, {}, {ci: [] for ci in cidx}, cidx, lam_host,
                    seed_host, np.zeros(B, bool), set(), degraded, recovery,
                    attempt, n_requeues, bucket_launches))
    finally:
        if sink is not None:
            sink.close()
        if rt is not None:
            rt.wait()

    done_rows = [r for r in rows if r is not None]
    assert len(done_rows) == len(cells)
    n_bucket_cells: Dict[int, int] = {}
    for b in cell_bucket:
        n_bucket_cells[b] = n_bucket_cells.get(b, 0) + 1
    return AtlasResult(
        rows=done_rows, n_cells=len(cells), n_lanes=len(cells) * S,
        n_programs=len(units), n_launches=n_launches,
        seq_launches=seq_launches, n_rewrites=n_rewrites,
        n_step_compiles=n_step_compiles,
        total_slots=sum(r.total_slots for r in done_rows),
        full_slots=sum(r.full_slots for r in done_rows),
        slots_saved=sum(r.slots_saved for r in done_rows),
        launch_slots_saved=launch_slots_saved,
        dims=dims, T=eff_T, chunk=eff_chunk,
        bucket_dims=list(bucket_dims),
        bucket_cells=n_bucket_cells,
        bucket_launches=dict(bucket_launches),
        n_requeues=n_requeues, slot_steps=slot_steps, device=str(dev),
        stream_records=sink.records if sink is not None else [],
        resumed_from=(resumed["n_launches"] if resumed is not None
                      else None),
        degraded=degraded, recovery_plan=recovery,
        n_fault_retries=rt.n_retries if rt is not None else 0)


def sweep_policy_surface(families: Sequence[str],
                         topo_seeds: Sequence[int], *,
                         policies: Sequence[str] = ("pi3", "pi3_reg",
                                                    "pi3bar"),
                         eps_b: float = 0.01, **kw) -> AtlasResult:
    """Atlas over policies: one sweep of (policy x family x topo_seed),
    every policy on the same topologies against the same per-cell exact
    bounds.  Pivot the rows with `report.policy_surface_table`; keyword
    args pass through to `sweep_lambda_max`."""
    cells = [AtlasJob(scenario=f, policy=p, topo_seed=int(ts), eps_b=eps_b)
             for p in policies for f in families for ts in topo_seeds]
    return sweep_lambda_max(cells, **kw)


def _atlas_extra(group, g_launches, n_launches, seq_launches, n_rewrites,
                 launch_slots_saved, n_step_compiles, machines, rows,
                 pending, chunks_used, probes_of, cidx, lam_host,
                 seed_host, parked, active, degraded, recovery, attempt,
                 n_requeues, bucket_launches) -> dict:
    """The sweep's cursor for one checkpoint, as JSON.

    Machines, finished rows and attempt counters are global (every cell,
    so finished batches restore without replay); the lane tables
    (``lam_host``, ``seed_host``, ``parked``) and pending probes are the
    current (group x bucket) batch's only.  ``group`` is the batch cursor:
    the bucket follows from the fixed batch order."""
    from repro_torch.runtime import resilience as rz

    return {
        "group": group, "g_launches": g_launches,
        "n_launches": n_launches, "seq_launches": seq_launches,
        "n_rewrites": n_rewrites,
        "launch_slots_saved": launch_slots_saved,
        "n_step_compiles": n_step_compiles,
        "n_requeues": n_requeues,
        "bucket_launches": {str(b): int(n)
                            for b, n in bucket_launches.items()},
        "machines": {str(ci): m.to_state()
                     for ci, m in enumerate(machines)},
        "rows": {str(ci): rz.row_state(r)
                 for ci, r in enumerate(rows) if r is not None},
        "attempt": {str(ci): int(a) for ci, a in enumerate(attempt)},
        "pending": {str(ci): int(k) for ci, k in pending.items()},
        "chunks_used": {str(ci): int(n) for ci, n in chunks_used.items()},
        "probes": {str(ci): [rz.probe_state(p) for p in probes_of[ci]]
                   for ci in cidx},
        "lam_host": [float(x) for x in lam_host],
        "seed_host": [int(x) for x in seed_host],
        "parked": [bool(x) for x in parked],
        "active": sorted(int(ci) for ci in active),
        "degraded": {str(ci): v for ci, v in degraded.items()},
        "recovery": rz.plan_state(recovery),
    }


def _finish_row(cell: AtlasJob, bound: float, step: float, bis: Bisection,
                probes: Sequence[RateProbe], degraded: bool = False,
                bucket: int = 0, n_requeues: int = 0) -> AtlasRow:
    full = sum(p.slots_run + p.slots_saved for p in probes)
    run_slots = sum(p.slots_run for p in probes)
    return AtlasRow(
        scenario=cell.scenario, policy=cell.policy, eps_b=cell.eps_b,
        topo_seed=cell.topo_seed,
        lam_max=bis.k_lo * step, bound_exact=bound,
        ratio=bis.k_lo * step / bound,
        lo=bis.k_lo * step, hi=bis.k_hi * step,
        n_calls=len(probes), n_iters=bis.n_iters,
        undecided=bis.undecided_hi,
        hi_certain=(None if bis.k_hi_certain is None
                    else bis.k_hi_certain * step),
        total_slots=run_slots, full_slots=full,
        slots_saved=full - run_slots,
        probes=tuple(probes), degraded=degraded, bucket=bucket,
        n_requeues=n_requeues)
