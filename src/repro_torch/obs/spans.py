"""Spans and counters of the port's run loops, on the profiler's clock.

Recording is off unless a caller opens it:

    from repro_torch.obs import spans
    with spans.recording(device_events=True) as rec:
        run_fleet(jobs, T=4096, chunk=512, early_stop=True)
    rec.spans()      # [{name, id, parent, run, t0_ns, t1_ns, ...}]
    rec.counters()   # {name: total}

While it is off, `span(name)` returns one shared no-op context manager and
`count(name, n)` is one branch.  The run loops call both at chunk or block
granularity, never inside code captured into a CUDA graph, so the graphs
and every result are the same with recording on or off.

A span record holds ``name``, ``id``, ``parent`` (the id of the span open
around it on the same thread, or None), ``run`` (the id of the outermost
span it sits under, its own for an outermost span), and ``t0_ns``/``t1_ns``,
host times in the Unix-epoch nanoseconds that `torch.profiler`'s events
carry: `time.perf_counter_ns()` shifted by one offset taken as recording
opens.  A span given a CUDA ``device`` while ``device_events`` is on also
records a `torch.cuda.Event` pair on the device's current stream at its
entry and exit, without a synchronise; `spans()` synchronises and resolves
them against an anchor event recorded when recording opened into
``d0_ns``/``d1_ns`` on the same timeline.

Counters of the run loops (`count`): ``host.readback_bytes``, the bytes of
the blocking device-to-host reads the fleet's loop makes (each read is one
``fleet.readback`` span).  How many reads, captures or nvcc runs a run
made is the number of its ``fleet.readback``, ``graph.capture`` or
``kernel.build`` spans.

Records stay in memory; there is no exporter.  One recording is open at a
time, in the process.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

_NULL = contextlib.nullcontext()
#: The open recorder, or None while recording is off.
_active: Optional["Recorder"] = None


class Recorder:
    """What one `recording()` holds: span records, counters and, with
    ``device_events``, the anchor of the device timeline."""

    def __init__(self, device_events: bool):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._records: List[dict] = []
        self._counts: Dict[str, float] = {}
        self._anchor = None
        self._resolved = False
        wall, mono = time.time_ns(), time.perf_counter_ns()
        self.offset_ns = wall - mono
        if device_events:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
                self._anchor = (anchor, self.now_ns())

    def now_ns(self) -> int:
        """The host's time on the profiler's clock."""
        return time.perf_counter_ns() + self.offset_ns

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _count(self, name: str, n) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def spans(self) -> List[dict]:
        """Every closed span, in the order they closed; device intervals
        resolved (the device synchronised first)."""
        if not self._resolved and any("_events" in r for r in self._records):
            import torch
            torch.cuda.synchronize()
            anchor, t_anchor = self._anchor
            for r in self._records:
                ev = r.pop("_events", None)
                if ev is not None:
                    r["d0_ns"], r["d1_ns"] = (
                        t_anchor + int(round(anchor.elapsed_time(e) * 1e6))
                        for e in ev)
        self._resolved = True
        return list(self._records)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counts)


class _Span:
    """One open span (the context manager `span` returns while
    recording)."""

    __slots__ = ("rec", "name", "stream", "record")

    def __init__(self, rec: Recorder, name: str, stream):
        self.rec, self.name, self.stream = rec, name, stream

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        sid = next(rec._ids)
        self.record = {"name": self.name, "id": sid,
                       "parent": stack[-1]["id"] if stack else None,
                       "run": stack[0]["id"] if stack else sid}
        stack.append(self.record)
        if self.stream is not None:
            import torch
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(self.stream)
            self.record["_events"] = (e0,)
        self.record["t0_ns"] = rec.now_ns()
        return self.record

    def __exit__(self, *exc):
        rec, r = self.rec, self.record
        if self.stream is not None:
            import torch
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(self.stream)
            r["_events"] = (r["_events"][0], e1)
        r["t1_ns"] = rec.now_ns()
        rec._stack().pop()
        rec._records.append(r)
        return False


def span(name: str, device=None):
    """A context manager around one piece of a run loop's work (see the
    module's docstring); the shared no-op one while recording is off.
    ``device``: where the span's work runs; a CUDA device gets device
    events when the recording asked for them."""
    rec = _active
    if rec is None:
        return _NULL
    stream = None
    if rec._anchor is not None and device is not None and \
            getattr(device, "type", None) == "cuda":
        import torch
        stream = torch.cuda.current_stream(device)
    return _Span(rec, name, stream)


def traced(name: str):
    """Decorator: each call of the function is one span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _active is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the open recording, if any."""
    rec = _active
    if rec is not None:
        rec._count(name, n)


@contextlib.contextmanager
def recording(device_events: bool = False):
    """Record spans and counters inside the block; yields the `Recorder`.
    ``device_events`` records a CUDA event pair around every span given a
    CUDA device (without a card the spans stay host-only)."""
    global _active
    if _active is not None:
        raise RuntimeError("spans are already recording")
    rec = Recorder(device_events)
    _active = rec
    try:
        yield rec
    finally:
        _active = None
