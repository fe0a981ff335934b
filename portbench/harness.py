"""One run of one benchmark cell, driven by data.

Everything that belongs to a cell is found by name:

  * BENCHMARK.json's `workloads` entry (config, traffic, chips) and its
    `end_to_end` / `per_layer` metrics;
  * `portbench/workloads/<cell>.json`: the entry module, the runs to trace,
    the correctness sample and the limits of the numbers compared;
  * `portbench/configs/<config>.json` (BENCHMARK.json's `file`) and
    `portbench/traffic/<traffic>.json`;
  * `portbench/entries/<entry>.py` (a class with `setup`, `run`,
    `lane_slots`, `sample`, `answers`, `reference`, `control`, `compare`,
    `kernel_launches`) and `portbench/metrics/<metric>.py`
    (a `read(reading)` function).

`run_cell` makes one run: set-up (the program's build, the inputs, one
whole warm run at the cell's shapes), then either the measured window
(whole runs until the seconds have passed; the end-to-end metrics) or the
traced window (the per-layer metrics, `busy_s`, `window_s`, `breakdown`),
then the comparison with the plain reference that decides `correct`.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: Traced windows tried before a run gives up on one that kept every fused
#: slot-step launch.
TRACE_ATTEMPTS = 3


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's whole description: BENCHMARK.json's entry with its
    workload file, configuration and traffic, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_data"] = load_json(root / configs[cell["config"]]["file"])
    cell["traffic_data"] = load_json(HERE / "traffic" /
                                     f"{cell['traffic']}.json")
    cell["params"] = load_json(HERE / "workloads" / f"{name}.json")

    def reports(m):
        return name in m.get("workloads", [name])
    cell["end_to_end"] = [m for m in bench["end_to_end"] if reports(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if reports(m)]
    return cell


def make_entry(cell: dict, seed: int, device):
    mod = importlib.import_module(f"portbench.entries.{cell['params']['entry']}")
    return mod.ENTRY(cell, seed, device)


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Outcome:
    """What one run gives: the result line's fields and the numbers
    compared, each (name, value, limit)."""

    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: list
    breakdown: dict | None = None


def _fused():
    """The program's fused slot-step launches so far: eager + replayed
    (captured launches run only when replayed)."""
    from repro_torch.kernels.bp_slot.kernel import slot_step_fused as k
    return k.launches + k.replayed


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def judge(entry, answers: list, ref: dict) -> tuple:
    """The comparison that decides `correct`: each run's sampled answers
    against the plain reference's.  Returns (checks [(name, worst value
    over the runs, limit)], runs failed)."""
    limits = entry.params["limits"]
    worst, failed = {}, 0
    for a in answers:
        nums = entry.compare(a, ref)
        failed += any(nums[k] > limits[k] for k in limits)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return [(k, worst[k], limits[k]) for k in limits], failed


def _traced(entry, n_runs: int, device) -> tuple:
    """(results, trace, batched slots) of ``n_runs`` whole runs traced, the
    window taken again while it kept fewer fused slot-step records than
    the program's counters launched."""
    from portbench import tracing
    from portbench.layers import SLOT_KERNEL
    for _ in range(TRACE_ATTEMPTS):
        before = _fused()
        results, tr = tracing.trace_window(
            lambda: [entry.run() for _ in range(n_runs)])
        slots = _fused() - before
        kept = len(tr.named(SLOT_KERNEL))
        if device == "cpu" or kept >= slots:
            return results, tr, slots
        print(f"traced window kept {kept} of {slots} fused launches; taken "
              f"again", file=sys.stderr)
    raise RuntimeError("no traced window kept every fused launch")


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None,
             root: pathlib.Path = ROOT, cell: dict | None = None) -> Outcome:
    """One run of cell ``name`` (see the module's docstring).  ``t0`` is
    when the process started, the start of the set-up time."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cell or cell_spec(name, root)
    entry = make_entry(cell, seed, device)
    entry.setup()
    entry.run()                                   # warm: builds, captures
    _sync(device)
    setup_s = time.perf_counter() - t0

    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        results, lane_slots, ends = [], 0, []
        start = time.perf_counter()
        while True:
            r = entry.run()
            _sync(device)
            results.append(r)
            lane_slots += entry.lane_slots(r)
            ends.append(time.perf_counter() - start)
            if ends[-1] >= seconds:
                break
        wall = ends[-1]
        print(f"window: {len(ends)} runs, ends at {[round(e, 4) for e in ends]}"
              f" s", file=sys.stderr)
        for m in cell["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] == entry.metric:
                metrics[m["name"]] = {"value": lane_slots / wall,
                                      "unit": m["unit"]}
    else:
        from portbench.layers import Reading
        results, tr, slots = _traced(entry, int(cell["params"]["trace_runs"]),
                                     device)
        kind = device_info(device)["kind"]
        peaks = load_json(HERE / "roofline" / "peaks.json").get(kind)
        reading = Reading(tr, slots, entry.kernel_launches(results), peaks)
        for m in cell["per_layer"]:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        del tr, reading       # a traced fleet run holds ~4.6 M device records

    dev = {**device_info(device), **dev_extra}
    idx = entry.sample()
    answers = [entry.answers(r, idx) for r in results]
    attempted = len(results)
    del results
    checks, failed = judge(entry, answers, entry.reference(idx))
    return Outcome(correct=failed == 0, attempted=attempted, failed=failed,
                   metrics=metrics, device=dev, checks=checks,
                   breakdown=breakdown)
