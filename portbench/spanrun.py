"""Per-layer numbers from the program's own spans (`repro_torch.obs.spans`).

The span run is one whole run of the cell's warm entry with spans
recording, device events on, and no profiler.  Its readers:

  * `untraced_idle`: 100 x (1 - the union of the inner spans' device
    intervals / the run's wall), the wall from the first outer span's start
    to the last outer span's end, or to the last device interval's end
    where the device finishes after the host (a sweep returns with its last
    blocks queued);
  * `entry_host_ms`: the outer spans' wall less the inner spans' and the
    waits', summed over the run: host work that neither launches the
    device's work nor waits for it.

Idle inside one inner span's device interval counts as busy.  A program
without spans (no `repro_torch.obs.spans`), or a run off the card, gives
nothing to read: the readers return None.

The harness hands a metric reader only the traced window's `Reading`.  Its
`spans` attribute, where a harness sets one, is read as the span run; else
the span run is made once per reading, after the traced window and one more
whole run, on the entry that the harness's `run_cell` (the reader's caller)
holds.  What the profiler leaves in the process outlasts the window: the
first run after it pays once (π3̄ on an H100: 39 ms of `trace.arrivals`
against 4–6 ms), and the host's `cudaGraphLaunch` calls stay slow for
longer (the fleet's chunk spans 1.6–2.0 s a run against 0.02 s in a
fresh process).  So the readings made here, after the window, run above
those of a fresh process's span run (`main` below); a span run before
the window, or in a process of its own, would not pay this.

    python portbench/spanrun.py --workload <cell> --seed <n> \\
        [--runs 3] [--cost 0] [--window 0]

runs the span run ``--runs`` times in one process, one JSON line each;
``--cost k`` then times k pairs of whole runs with recording off and on,
in turns; ``--window 1`` traces one whole run under the harness's profiler
with host spans recording, and prints its idle gaps by the span open at
each gap (`gaps_by_span`) and how many of its `cudaGraphLaunch` records lie
inside a chunk or block span, then ``--runs`` span runs again after it.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: The spans each entry's readers reduce: (outer, inner, waits).
LAYERS = {"fleet": ("fleet.run", "fleet.chunk", ("fleet.readback",)),
          "trace": ("trace.sweep", "trace.block", ())}
#: Runtime records a chunk or block span has to hold.
GRAPH_LAUNCH = "cudaGraphLaunch"


def _named(spans: list, name: str) -> list:
    return [r for r in spans if r["name"] == name]


def _as_host(spans: list) -> list:
    """Span records as a `Trace`'s host events, sorted by start."""
    return sorted(((r["name"], r["t0_ns"], r["t1_ns"]) for r in spans),
                  key=lambda h: h[1])


def untraced_idle(spans: list, outer: str, inner: str):
    """The device's idle share of the run's wall, in % (see the module's
    docstring); None without outer spans or device intervals."""
    from portbench.tracing import Trace
    runs = _named(spans, outer)
    dev = sorted((inner, r["d0_ns"], r["d1_ns"]) for r in _named(spans, inner)
                 if "d0_ns" in r)
    if not runs or not dev:
        return None
    start = min(r["t0_ns"] for r in runs)
    end = max(max(r["t1_ns"] for r in runs), max(e for _, _, e in dev))
    busy = Trace(dev, [], start, end)
    return 100.0 * (1.0 - busy.busy_s() / busy.window_s)


def entry_host_ms(spans: list, outer: str, inner: str, waits=()):
    """Host milliseconds of the run outside the inner spans and the waits;
    None without outer spans."""
    runs = _named(spans, outer)
    if not runs:
        return None

    def wall(name):
        return sum(r["t1_ns"] - r["t0_ns"] for r in _named(spans, name))
    rest = wall(outer) - wall(inner) - sum(wall(w) for w in waits)
    return rest * 1e-6


def span_run(entry, device, settle: int = 0):
    """The spans of one whole run of ``entry`` (warm) with device events
    on, after ``settle`` whole runs unrecorded; None off the card or where
    the program records no spans."""
    if not str(device).startswith("cuda"):
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    import torch
    for _ in range(settle):
        entry.run()
    with spans.recording(device_events=True) as rec:
        entry.run()
        torch.cuda.synchronize()
    return rec.spans()


def _harness_entry():
    """(entry, device) of the harness's `run_cell` frame above the reader,
    or (None, None)."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and "entry" in f.f_locals:
            return f.f_locals["entry"], f.f_locals.get("device")
        f = f.f_back
    return None, None


def spans_of(reading):
    """The span run of ``reading``'s cell (see the module's docstring), or
    None."""
    got = getattr(reading, "spans", None)
    if got is not None:
        return got
    if "_span_run" not in vars(reading):
        entry, device = _harness_entry()
        reading._span_run = (span_run(entry, device, settle=1)
                             if entry is not None else None)
    return reading._span_run


def reader(kind: str, what: str):
    """The ``read(reading)`` of metric ``<kind>.<what>`` for entry kind
    ``kind`` ("fleet" or "trace")."""
    outer, inner, waits = LAYERS[kind]

    def read(reading):
        got = spans_of(reading)
        if not got:
            return None
        if what == "untraced_idle":
            return untraced_idle(got, outer, inner)
        return entry_host_ms(got, outer, inner, waits)
    return read


def gaps_by_span(trace, spans: list, top: int = 10) -> list:
    """[[span name, seconds]]: ``trace``'s device idle gaps, as
    `Trace.idle_gaps` sums them, by the innermost program span open at
    each gap's middle ("host idle" where none was)."""
    return dataclasses.replace(trace, host=_as_host(spans)).idle_gaps(top)


def launches_inside(trace, spans: list, names) -> dict:
    """How many of ``trace``'s `cudaGraphLaunch` runtime records lie inside
    a span named in ``names``, and the largest distance of one outside."""
    held = sorted((r["t0_ns"], r["t1_ns"]) for r in spans
                  if r["name"] in names)
    starts = [s for s, _ in held]
    n = inside = 0
    worst = 0
    for name, s, e in trace.host:
        if name != GRAPH_LAUNCH:
            continue
        n += 1
        i = bisect.bisect_right(starts, s) - 1
        miss = None
        for j in (i, i + 1):
            if 0 <= j < len(held):
                t0, t1 = held[j]
                d = max(t0 - s, e - t1, 0)
                miss = d if miss is None else min(miss, d)
        if miss == 0:
            inside += 1
        elif miss is not None:
            worst = max(worst, miss)
    return {"graph_launches": n, "inside": inside, "largest_miss_ns": worst}


def _seconds_by_name(spans: list) -> dict:
    out = {}
    for r in spans:
        out[r["name"]] = out.get(r["name"], 0) + (r["t1_ns"] - r["t0_ns"])
    return {k: v * 1e-9 for k, v in sorted(out.items())}


def _summary(spans: list, kind: str) -> dict:
    outer, inner, waits = LAYERS[kind]
    runs = _named(spans, outer)
    wall = max(r["t1_ns"] for r in runs) - min(r["t0_ns"] for r in runs)
    return {"wall_s": wall * 1e-9,
            "untraced_idle": untraced_idle(spans, outer, inner),
            "entry_host_ms": entry_host_ms(spans, outer, inner, waits),
            "device_s": sum(r["d1_ns"] - r["d0_ns"]
                            for r in _named(spans, inner)
                            if "d0_ns" in r) * 1e-9,
            "spans_s": _seconds_by_name(spans),
            "n": _n_by_name(spans)}


def _n_by_name(spans: list) -> dict:
    return {k: len(_named(spans, k))
            for k in sorted({r["name"] for r in spans})}


def _rate(entry, record: bool) -> float:
    """Lane-slots a second of one whole run, spans recording or not."""
    import torch
    from repro_torch.obs import spans
    t0 = time.perf_counter()
    if record:
        with spans.recording(device_events=True):
            res = entry.run()
            torch.cuda.synchronize()
    else:
        res = entry.run()
        torch.cuda.synchronize()
    return entry.lane_slots(res) / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--window", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("the span run needs a CUDA device", file=sys.stderr)
        return 3
    from portbench import harness, tracing
    from repro_torch.obs import spans
    cell = harness.cell_spec(args.workload)
    kind = cell["params"]["entry"]
    entry = harness.make_entry(cell, args.seed, "cuda")
    with spans.recording() as setup:
        entry.setup()
        entry.run()
        torch.cuda.synchronize()
    print(json.dumps({"setup_s": time.perf_counter() - t_start,
                      "setup_spans_s": _seconds_by_name(setup.spans()),
                      "setup_spans_n": _n_by_name(setup.spans()),
                      "setup_counters": setup.counters()}), flush=True)
    for i in range(args.runs):
        print(json.dumps({"span_run": i,
                          **_summary(span_run(entry, "cuda"), kind)}),
              flush=True)
    if args.cost:
        rates = {False: [], True: []}
        for i in range(2 * args.cost):       # off, on, on, off, ...
            on = bool(i % 2) != bool((i // 2) % 2)
            rates[on].append(_rate(entry, on))
        off, on = (statistics.median(rates[k]) for k in (False, True))
        print(json.dumps({"cost": 1.0 - on / off, "off": rates[False],
                          "on": rates[True]}), flush=True)
    if args.window:
        with spans.recording() as rec:
            _, tr = tracing.trace_window(entry.run)
        got = rec.spans()
        print(json.dumps({"gaps_by_span": gaps_by_span(tr, got),
                          "idle_gaps": tr.idle_gaps(),
                          "busy_s": tr.busy_s(), "window_s": tr.window_s,
                          **launches_inside(tr, got, (LAYERS[kind][1],))}),
              flush=True)
        for i in range(args.runs):          # as the benchmark reads them
            print(json.dumps({"span_run_after_window": i,
                              **_summary(span_run(entry, "cuda"), kind)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
