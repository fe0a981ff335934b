"""A live view over ``*_stream.jsonl`` telemetry.

A copy of `repro.obs.follow` over the port's own schema module.  It tails
the stream files the engines append to (`StreamSink(path=...)` flushes
per record), renders per-(kind, group) rolling medians for fleet and
serving streams and per-family bisection-bracket progress for in-flight
atlas runs, and repeats every ``--interval`` seconds.  Records are
validated lazily (bad lines render as a warning, not a crash) and a
truncated final line (a writer mid-append) is ignored until the next tick.

The rolling median is a bounded deque per metric, re-aggregated every
render, so one noisy chunk cannot spike the displayed rate.  An *empty*
window is NaN, never 0.0 (``drift_med 0.0`` is the stability boundary):
it renders as ``—`` and the alert checks (``drift_med`` crossing 0,
``shed_frac`` spikes) skip it.

Run it as ``python -m repro_torch.obs.follow [--follow] FILE...``.
"""
from __future__ import annotations

import argparse
import glob
import math
import sys
import time
from collections import deque
from statistics import median
from typing import Dict, Iterable, List, Sequence

from . import schema

#: shed_frac level below which a spike is never alerted (noise floor).
SHED_SPIKE_FLOOR = 0.05
#: spike = latest shed_frac_med > SHED_SPIKE_RATIO × rolling median.
SHED_SPIKE_RATIO = 2.0


class RollingMedian:
    """Median over a bounded trailing window of pushed values.

    An empty window is **NaN**, not 0.0: the old zero default rendered a
    `drift_med 0.0` — the exact stability boundary — before any record
    arrived, indistinguishable from a genuinely zero-drift stream.  NaN
    propagates through comparisons as False, so alert thresholds skip
    empty windows for free, and the renderer shows ``—``."""

    def __init__(self, window: int = 8):
        self._buf: deque = deque(maxlen=max(int(window), 1))

    def push(self, x: float) -> None:
        self._buf.append(float(x))

    @property
    def value(self) -> float:
        return median(self._buf) if self._buf else math.nan

    def __len__(self) -> int:
        return len(self._buf)


def _roll(records: List[dict], field: str, window: int) -> float:
    rm = RollingMedian(window)
    for rec in records[-window:]:
        if field in rec:
            rm.push(rec[field])
    return rm.value


def _fmt(x: float, spec: str = ".3f") -> str:
    """Format a rolling value; an empty (NaN) window renders as ``—``."""
    return "—" if math.isnan(x) else format(x, spec)


def _fmt_verdicts(counts: dict) -> str:
    return " ".join(f"{k}:{v}" for k, v in sorted(counts.items()))


def _render_fleet(recs: List[dict], window: int) -> str:
    last = recs[-1]
    drift = _roll(recs, "drift_med", window)
    # Alert: a *populated* window whose median drift crosses into >= 0
    # (the paper's instability boundary).  NaN (empty window) compares
    # False, so the alert can never fire off the missing-data default.
    alert = "  !! drift>=0" if drift >= 0.0 else ""
    return (f"fleet   g{last['group']}  chunk {last['chunk']:>4}  "
            f"t={last['t']:>8}  sims={last['n_sims']:>4} | "
            f"useful ~{_fmt(_roll(recs, 'useful_rate_med', window))}  "
            f"backlog ~{_fmt(_roll(recs, 'backlog_med', window), '.1f')}  "
            f"drift ~{_fmt(drift)}  "
            f"max_q {last['max_queue_med']:.1f}  "
            f"decided {last['n_decided']}/{last['n_sims']}  "
            f"[{_fmt_verdicts(last['verdicts'])}]" + alert)


def _render_serving(recs: List[dict], window: int) -> str:
    last = recs[-1]
    shed = _roll(recs, "shed_frac_med", window)
    # Alert: the latest shed fraction spikes to SHED_SPIKE_RATIO × the
    # rolling median, above the noise floor.  Requires a populated window
    # (NaN median → both comparisons False → no alert).
    shed_last = float(last["shed_frac_med"])
    alert = ("  !! shed spike"
             if shed_last > SHED_SPIKE_FLOOR
             and shed_last > SHED_SPIKE_RATIO * shed else "")
    return (f"serving g{last['group']}  chunk {last['chunk']:>4}  "
            f"t={last['t']:>8}  sims={last['n_sims']:>4} | "
            f"qps ~{_fmt(_roll(recs, 'qps_med', window), '.2f')}  "
            f"shed ~{_fmt(shed)}  "
            f"p99 ~{_fmt(_roll(recs, 'p99_med', window), '.0f')}  "
            f"gate {last['gate_open_frac']:.2f}  "
            f"[{_fmt_verdicts(last['verdicts'])}]" + alert)


def _render_atlas(recs: List[dict], window: int) -> List[str]:
    last = recs[-1]
    n_cells = last["n_active_cells"] + last["n_done_cells"]
    requeues = (f"  requeues {last['n_requeues']}"
                if last.get("n_requeues") else "")
    lines = [(f"atlas   g{last['group']}/b{last.get('bucket', 0)}  "
              f"launch {last['chunk']:>4}  "
              f"t={last['t']:>8}  lanes={last['n_sims']:>4} | "
              f"done {last['n_done_cells']}/{n_cells} cells  "
              f"probes {last['n_probes']}  "
              f"bracket ~{_fmt(_roll(recs, 'bracket_rel_width_med', window))} "
              f"of bound" + requeues)]
    for fam, row in sorted(last["families"].items()):
        bar = "#" * int(10 * row["done"] / max(row["cells"], 1))
        lines.append(f"    {fam:<18} {row['done']}/{row['cells']} done "
                     f"[{bar:<10}] bracket {row['lo_med']:.3f}"
                     f"..{row['hi_med']:.3f} of bound")
    return lines


def render(records: Iterable[dict], window: int = 8) -> str:
    """Render one telemetry frame from parsed stream records (pure —
    the unit-testable core of the follow loop)."""
    by_stream: Dict[tuple, List[dict]] = {}
    bad = 0
    for rec in records:
        if schema.validate_record(rec):
            bad += 1
            continue
        by_stream.setdefault((rec["kind"], rec["group"]), []).append(rec)
    lines: List[str] = []
    for (kind, _), recs in sorted(by_stream.items()):
        if kind == "fleet":
            lines.append(_render_fleet(recs, window))
        elif kind == "serving":
            lines.append(_render_serving(recs, window))
        elif kind == "atlas":
            lines.extend(_render_atlas(recs, window))
    if bad:
        lines.append(f"!! {bad} records failed schema validation "
                     f"(schema_version {schema.SCHEMA_VERSION})")
    if not lines:
        lines.append("(no records yet)")
    return "\n".join(lines)


def follow(paths: Sequence[str], interval: float = 2.0, window: int = 8,
           max_ticks: int | None = None, out=print) -> int:
    """Tail the stream files, rendering a frame every ``interval`` seconds
    until interrupted (or ``max_ticks`` frames, for tests).  Returns the
    number of frames rendered."""
    ticks = 0
    try:
        while True:
            frames = []
            for p in paths:
                try:
                    recs = schema.read_stream_jsonl(p)
                except OSError:
                    continue
                frames.append(f"== {p} ==\n" + render(recs, window=window))
            out("\n".join(frames) if frames
                else f"(waiting for {', '.join(paths)})")
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return ticks
            time.sleep(interval)
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        return ticks


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.follow",
        description="Render (or --follow) *_stream.jsonl telemetry")
    ap.add_argument("paths", nargs="*",
                    help="stream JSONL files (default: ./*_stream.jsonl)")
    ap.add_argument("--follow", action="store_true",
                    help="keep tailing instead of rendering once")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between frames with --follow")
    ap.add_argument("--window", type=int, default=8,
                    help="rolling-median window (records)")
    args = ap.parse_args(argv)
    paths = args.paths or sorted(glob.glob("*_stream.jsonl"))
    if not paths:
        print("follow: no *_stream.jsonl files found",
              file=sys.stderr)
        return 1
    follow(paths, interval=args.interval, window=args.window,
           max_ticks=None if args.follow else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
