"""Chunk-boundary telemetry: probe leaves off the device between chunks.

Port of `repro.obs.emitter`.  The engines' chunk loops are host loops
around in-place chunk steps (on CUDA, replays of one captured graph), so
telemetry is tapped *between* chunks, never inside one: the captured graph
is the same with the stream on or off, and turning it on adds no capture.

The reference hands its probe to an ordered `io_callback`.  Here one
`ChunkEmitter.emit` does three things, none of which blocks the host on
the device:

  1. **Snapshot** the probe leaves into a device buffer, on the compute
     stream right after the chunk.  The next chunk's replay overwrites the
     carry in place, and the snapshot is ordered before it: this is the
     port's form of the reference's read-before-donate hazard (its
     emitter copies every leaf before the callback for the same reason).
  2. **Copy** the snapshot to pinned host memory on a side stream that
     waits on an event recorded after the snapshot; an event recorded
     after the copy marks it done.
  3. **Assemble** the record on a worker thread, which waits on that event,
     differences the probe against the previous one and hands the record
     to the `StreamSink`.

The snapshot buffers are double-buffered: buffer i is written again two
emits later, and only after the worker has released it, which it does
once the copy out of it finished and the host values are taken.  So the
host runs at most two chunks ahead of the records, and a slow consumer
(a ``stream_log`` that blocks) slows the engine down rather than losing or
reordering a record.  On CPU tensors there is no stream: the snapshot is a
copy, and the worker path is the same.  `close()` drains the worker and
raises any error it met.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.queues import VERDICT_NAMES, VERDICT_UNDECIDED
from . import schema

#: Snapshot buffers per emitter: the chunks the host may run ahead of the
#: records it has assembled.
N_BUFFERS = 2


class StreamSink:
    """Fan-out for finished records: accumulate them, optionally append
    JSONL to ``path`` (flushed per record, so a follow tail sees them
    live), optionally call ``log``.  Thread-safe: records arrive on the
    emitters' worker threads.

    ``append=True`` is the resumed-run mode: an existing file is preloaded
    (its records seed ``self.records``, cut to the parseable prefix, so a
    killed writer's torn last line is dropped) and later writes are
    deduplicated against the per-(kind, group) chunk clock.  A resumed
    engine replays the launches after its snapshot, so a record the
    killed run already made durable comes again bit-identically:
    suppressing ``chunk <= last_seen`` leaves exactly the uninterrupted
    stream.  ``resume`` records, which mark the seam, are exempt."""

    def __init__(self, path: str | None = None,
                 log: Callable[[dict], None] | None = None,
                 append: bool = False):
        self.records: List[dict] = []
        self._log = log
        self._lock = threading.Lock()
        self._clock: Dict[tuple, int] = {}   # (kind, group) -> last chunk
        self._dedupe = False
        self.n_preloaded = 0
        if path and append and os.path.exists(path):
            existing = schema.read_stream_jsonl(path)
            with open(path, "w") as f:        # drop any torn trailing line
                for rec in existing:
                    f.write(schema.jsonl_line(rec) + "\n")
            self.records.extend(existing)
            self.n_preloaded = len(existing)
            for rec in existing:
                if rec.get("kind") != "resume":
                    key = (rec.get("kind"), rec.get("group"))
                    c = self._clock.get(key)
                    if c is None or rec.get("chunk", 0) > c:
                        self._clock[key] = rec.get("chunk", 0)
            self._dedupe = True
            self._f = open(path, "a")
        else:
            self._f = open(path, "w") if path else None

    def write(self, rec: dict) -> None:
        with self._lock:
            if self._dedupe and rec.get("kind") != "resume":
                key = (rec["kind"], rec["group"])
                c = self._clock.get(key)
                if c is not None and rec["chunk"] <= c:
                    return           # already durable from the killed run
                self._clock[key] = rec["chunk"]
            self.records.append(rec)
            if self._f is not None:
                self._f.write(schema.jsonl_line(rec) + "\n")
                self._f.flush()
        if self._log is not None:
            self._log(rec)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ChunkEmitter:
    """One group's chunk-boundary telemetry: snapshot the probe leaves per
    chunk, difference consecutive probes into schema records on a worker
    thread, hand them to a `StreamSink`.

    ``kind`` picks the record assembler ("fleet" or "serving"); ``runner``
    supplies the chunk length and, for serving, the latency histogram's
    shape; ``n_real`` is the number of sims behind the medians."""

    def __init__(self, kind: str, group: int, n_real: int, runner,
                 sink: StreamSink):
        self._assemble = {"fleet": _fleet_record,
                          "serving": _serving_record}[kind]
        self._group = group
        self._n_real = n_real
        self._runner = runner
        self._sink = sink
        self._prev: dict | None = None
        self._chunk_idx = 0
        self._n_emitted = 0
        self._bufs: List[dict] = []
        self._free = [threading.Event() for _ in range(N_BUFFERS)]
        for ev in self._free:
            ev.set()
        self._side = None
        self._queue: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name=f"stream-{kind}-{group}")
        self._worker.start()

    def restore_clock(self, chunk_idx: int, prev: dict | None) -> None:
        """Resume support: pin the differencing clock to a restored chunk
        boundary.  ``prev`` is the probe of the restored carry, the probe
        the killed run last consumed, so the first record after the seam
        differences against the baseline an uninterrupted run would have
        used.  Call it before the first `emit`."""
        self._chunk_idx = int(chunk_idx)
        self._prev = (None if prev is None else
                      {k: (v.cpu().numpy().copy()
                           if isinstance(v, torch.Tensor) else np.array(v))
                       for k, v in prev.items()})

    def _buffers(self, leaves: Dict[str, torch.Tensor]) -> List[dict]:
        """Device snapshot and host buffers, allocated at the first emit."""
        if not self._bufs:
            cuda = next(iter(leaves.values())).is_cuda
            for _ in range(N_BUFFERS):
                dev = {k: torch.empty_like(v) for k, v in leaves.items()}
                host = ({k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in leaves.items()} if cuda else dev)
                self._bufs.append({"dev": dev, "host": host})
            if cuda:
                self._side = torch.cuda.Stream(
                    device=next(iter(leaves.values())).device)
        return self._bufs

    def emit(self, leaves: Dict[str, torch.Tensor]) -> None:
        """Snapshot one chunk-boundary probe and queue its record.  Call it
        right after the chunk, before the next chunk overwrites the carry
        the leaves read."""
        if self._error is not None:
            raise RuntimeError("stream worker failed") from self._error
        i = self._n_emitted % N_BUFFERS
        self._n_emitted += 1
        self._free[i].wait()        # its previous copy is done and read
        self._free[i].clear()
        buf = self._buffers(leaves)[i]
        for k, v in leaves.items():
            buf["dev"][k].copy_(v)
        done = None
        if self._side is not None:
            snap = torch.cuda.Event()
            snap.record()
            with torch.cuda.stream(self._side):
                self._side.wait_event(snap)
                for k, v in buf["dev"].items():
                    buf["host"][k].copy_(v, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._side)
        self._queue.put((i, done))

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            i, done = item
            try:
                if done is not None:
                    done.synchronize()
                probe = {k: v.numpy().copy()
                         for k, v in self._bufs[i]["host"].items()}
                self._free[i].set()
                rec = self._assemble(self._group, self._chunk_idx,
                                     self._runner, probe, self._prev,
                                     self._n_real)
                self._prev = probe
                self._chunk_idx += 1
                self._sink.write(rec)
            except Exception as e:          # raised again by emit/close
                self._error = e
                self._free[i].set()

    def close(self) -> None:
        """Assemble every queued record, stop the worker, and raise what
        it met."""
        self._queue.put(None)
        self._worker.join()
        if self._error is not None:
            raise RuntimeError("stream worker failed") from self._error


def _r4(x) -> float:
    return round(float(x), 4)


def _verdict_counts(verdict: np.ndarray) -> dict:
    v = verdict.astype(int)
    return {VERDICT_NAMES[k]: int((v == k).sum())
            for k in sorted(set(v.tolist()))}


def _fleet_record(group: int, chunk_idx: int, runner, probe: dict,
                  prev: dict | None, n_real: int) -> dict:
    """Difference two consecutive fleet probes into one windowed record.

    Rates are per-sim deltas over the sim's *own* slot delta (a frozen
    sim advances 0 slots; its last anchored rate/drift still reports), so
    early-stopped groups stream honest numbers."""
    def cur(name):
        return probe[name][:n_real].astype(np.float64)

    def delta(name):
        if prev is None:
            return cur(name)
        return cur(name) - prev[name][:n_real].astype(np.float64)

    dt = np.maximum(delta("t"), 1.0)
    verdict = probe["verdict"][:n_real]
    return schema.make_record(
        "fleet",
        group=group, chunk=chunk_idx,
        t=int(probe["t"][:n_real].max()), n_sims=n_real,
        useful_rate_med=_r4(np.median(delta("delivered_useful") / dt)),
        backlog_med=_r4(np.median(delta("sum_queue") / dt)),
        max_queue_med=_r4(np.median(cur("max_queue"))),
        drift_med=_r4(np.median(cur("last_drift"))),
        n_decided=int((verdict != VERDICT_UNDECIDED).sum()),
        verdicts=_verdict_counts(verdict))


def _hist_quantile(hist: np.ndarray, q: float, horizon: int,
                   n_bins: int) -> np.ndarray:
    """Host-side `core.latency.latency_quantiles` on [B, NB+1] numpy data."""
    total = hist.sum(axis=-1, keepdims=True)
    cum = np.cumsum(hist, axis=-1)
    bin_w = max(horizon // n_bins, 1)
    b = np.sum(cum < q * total, axis=-1)
    edge = np.minimum((b + 1) * bin_w, horizon).astype(np.float64)
    return np.where(total[..., 0] > 0, edge, 0.0)


def _serving_record(group: int, chunk_idx: int, runner, probe: dict,
                    prev: dict | None, n_real: int) -> dict:
    """The serving record: windowed medians across the group's sims, all
    values rounded so records diff cleanly."""
    def delta(name):
        cur = probe[name][:n_real].astype(np.float64)
        if prev is None:
            return cur
        return cur - prev[name][:n_real].astype(np.float64)

    ddlv = delta("delivered_useful")
    dadm = delta("admitted_total")
    dshed = delta("shed_total")
    doff = np.maximum(dadm + dshed, 1e-9)
    dhist = delta("hist")
    p99 = _hist_quantile(dhist, 0.99, runner.lat_horizon, runner.lat_bins)
    return schema.make_record(
        "serving",
        group=group, chunk=chunk_idx,
        t=int(probe["t"][:n_real].max()), n_sims=n_real,
        qps_med=_r4(np.median(ddlv) / runner.chunk),
        admitted_qps_med=_r4(np.median(dadm) / runner.chunk),
        shed_frac_med=_r4(np.median(dshed / doff)),
        p99_med=_r4(np.median(p99)),
        gate_open_frac=_r4(np.mean(probe["gate"][:n_real])),
        gate_flips=int(probe["gate_flips"][:n_real].sum()),
        verdicts=_verdict_counts(probe["verdict"][:n_real]))


def atlas_record(group: int, bucket: int, n_requeues: int,
                 g_launches: int, chunk: int, n_real: int,
                 cells, cidx, active, machines, steps, bounds, probes_of,
                 lane_verdicts: np.ndarray) -> dict:
    """One atlas launch's bisection-progress record, assembled from the
    host scheduler's state (port of `repro.fleet.atlas._atlas_record`).
    ``t`` is the per-lane dispatch count (launches x chunk): lanes reset
    their slot clock on probe rewrites, so the carry's own t is not a
    stream clock.  ``group`` is the (policy group x bucket) batch,
    ``bucket`` its size bucket."""
    def rel(ci, k):
        return k * steps[ci] / bounds[ci]

    widths = [rel(ci, machines[ci].k_hi - machines[ci].k_lo)
              for ci in cidx]
    fams: Dict[str, dict] = {}
    for ci in cidx:
        fam = fams.setdefault(cells[ci].scenario, {"cells": 0, "done": 0,
                                                   "_lo": [], "_hi": []})
        fam["cells"] += 1
        fam["done"] += ci not in active
        fam["_lo"].append(rel(ci, machines[ci].k_lo))
        fam["_hi"].append(rel(ci, machines[ci].k_hi))
    for fam in fams.values():
        fam["lo_med"] = round(float(np.median(fam.pop("_lo"))), 4)
        fam["hi_med"] = round(float(np.median(fam.pop("_hi"))), 4)
    v = lane_verdicts.astype(int)
    return schema.make_record(
        "atlas",
        group=group, bucket=bucket, n_requeues=n_requeues,
        chunk=g_launches - 1, t=g_launches * chunk,
        n_sims=n_real,
        n_active_cells=len(active),
        n_done_cells=len(cidx) - len(active),
        n_probes=sum(len(probes_of[ci]) for ci in cidx),
        bracket_rel_width_med=round(float(np.median(widths)), 4),
        verdicts={VERDICT_NAMES[k]: int((v == k).sum())
                  for k in sorted(set(v.tolist()))},
        families=fams)


def open_sink(stream: bool, stream_log=None,
              stream_path: str | None = None,
              append: bool = False) -> StreamSink | None:
    """The run's sink when any of the stream arguments asks for one
    (``stream_log`` and ``stream_path`` each imply ``stream``);
    ``append`` opens it in the resumed-run mode."""
    if stream or stream_log is not None or stream_path is not None:
        return StreamSink(path=stream_path, log=stream_log, append=append)
    return None
