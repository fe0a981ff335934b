"""Versioned stream-record schema: the one contract every ``*_stream.jsonl``
writer emits against (DESIGN.md §11).

A copy of `repro.obs.schema`: the same field tables, so `schema_digest()`
is the reference's blessed digest and the port's streams pass
`scripts/check_stream.py` and the reference's `validate_stream`.

A *stream record* is one flat JSON object per chunk boundary (fleet,
serving) or launch boundary (atlas).  Three invariants make the streams
CI-diffable and safe to tail from another process:

  1. **One schema, versioned.**  Every record carries ``schema_version``
     and ``kind``; the per-kind field tables below are the full key set —
     unknown keys are rejected, so an emitter cannot grow the record
     shape without touching this module.
  2. **Digest-gated evolution.**  `schema_digest()` hashes the field
     tables; `scripts/check_stream.py` compares it against
     ``BLESSED_DIGESTS[SCHEMA_VERSION]``.  Editing a field table without
     bumping ``SCHEMA_VERSION`` (and blessing the new digest) fails CI —
     a consumer can trust that records with equal versions have equal
     shapes.
  3. **Monotone stream clock.**  Within one file, ``t`` (simulated slots
     dispatched) is non-decreasing and ``chunk`` strictly increasing per
     ``(kind, group)`` — the property a `--follow` tail needs to render
     progress without re-sorting.

This module is pure Python: the CI gate and the follow viewer load it
without touching a device runtime.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, List

#: Bump when any field table below changes shape, and bless the new
#: digest in BLESSED_DIGESTS (scripts/check_stream.py enforces the pair).
#: v2: added the "resume" record kind (preemption-safe runs, DESIGN.md §12).
#: v3: atlas records gained "bucket" (the PadDims size bucket the launch
#:     unit runs in) and "n_requeues" (adaptive-horizon escalations so
#:     far) — the bucketed-atlas observability contract (DESIGN.md §13).
SCHEMA_VERSION = 3

# Field type tags: "int" (json integer, bools rejected), "num" (integer or
# float), "str", "dict" (nested object; contents are kind-specific and
# deliberately not pinned — counts keyed by verdict name / family name).
_COMMON = {
    "schema_version": "int",
    "kind": "str",
    "group": "int",      # compiled-program group index within the run
    "chunk": "int",      # per-group chunk/launch counter, 0-based
    "t": "int",          # stream clock: simulated slots dispatched per lane
    "n_sims": "int",     # real (non-mesh-replica) sims behind the medians
}

#: Per-kind field tables.  Keys = the exact (and only) keys a record of
#: that kind may carry.
STREAM_KINDS: Dict[str, Dict[str, str]] = {
    # fleet: windowed medians over the group's sims, differenced between
    # consecutive chunk-boundary probes of the donated carry.
    "fleet": {
        **_COMMON,
        "useful_rate_med": "num",   # d(delivered_useful)/d(t) median
        "backlog_med": "num",       # d(sum_queue)/d(t) median (mean backlog)
        "max_queue_med": "num",     # running max backlog median
        "drift_med": "num",         # anchored per-slot drift estimate median
        "n_decided": "int",         # sims with a latched verdict
        "verdicts": "dict",         # {verdict name: count}
    },
    # serving: the PR-6 per-chunk record, now schema-versioned.
    "serving": {
        **_COMMON,
        "qps_med": "num",
        "admitted_qps_med": "num",
        "shed_frac_med": "num",
        "p99_med": "num",
        "gate_open_frac": "num",
        "gate_flips": "int",
        "verdicts": "dict",
    },
    # atlas: host-side bisection progress, one record per group launch.
    "atlas": {
        **_COMMON,
        "bucket": "int",            # PadDims size bucket of this launch unit
        "n_requeues": "int",        # adaptive-horizon re-queues so far
        "n_active_cells": "int",    # cells still bisecting after this launch
        "n_done_cells": "int",      # cells with a finished search
        "n_probes": "int",          # rate probes harvested so far
        "bracket_rel_width_med": "num",  # median (hi-lo)/bound over cells
        "verdicts": "dict",         # {verdict name: lane count} this launch
        "families": "dict",         # {family: {cells, done, lo_med, hi_med}}
    },
    # resume: a preemption-safe engine picked the stream back up from a
    # checkpoint (DESIGN.md §12).  ``chunk``/``t`` are the restored
    # boundary's per-group clock, so a merged feed stays monotone; the
    # sink exempts this kind from duplicate-suppression.
    "resume": {
        **_COMMON,
        "engine": "str",        # fleet | serving | atlas
        "ckpt_step": "int",     # checkpoint step the run restored
        "n_preloaded": "int",   # records already durable from the killed run
    },
}


def schema_digest() -> str:
    """SHA-256 of the canonical field-table structure (version excluded:
    the digest answers "did the shape change", the version answers "was
    the change blessed")."""
    canon = json.dumps(STREAM_KINDS, sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()


#: version -> blessed digest of the field tables at that version.  A shape
#: edit must add/replace an entry *and* bump SCHEMA_VERSION, or
#: scripts/check_stream.py fails ("schema changed without a version bump").
BLESSED_DIGESTS: Dict[int, str] = {
    1: "cf81d7426080f2ac1b8123bcc45435a10196008787131209b3b24dcf181ba29c",
    2: "920d91e8d051be592b6a3478ceb752d7c0dd8cf840d6b5050bec7b820caef97e",
    3: "6b075e07750232b47eab5e3fb39a487ed0d1491a469b7aedcf7ab412e66f2398",
}


def _type_ok(tag: str, v) -> bool:
    if tag == "int":
        return isinstance(v, int) and not isinstance(v, bool)
    if tag == "num":
        return (isinstance(v, (int, float))
                and not isinstance(v, bool))
    if tag == "str":
        return isinstance(v, str)
    if tag == "dict":
        return isinstance(v, dict)
    raise ValueError(f"unknown type tag {tag!r}")


def make_record(kind: str, **fields) -> dict:
    """Assemble + validate one stream record.

    Fills ``schema_version`` and ``kind``; numpy scalars are coerced to
    plain Python so records serialize canonically.  Raises ``ValueError``
    on a field-table mismatch — an emitter drifting from the schema is a
    bug, not a warning.
    """
    table = STREAM_KINDS.get(kind)
    if table is None:
        raise ValueError(f"unknown stream kind {kind!r} "
                         f"(have {sorted(STREAM_KINDS)})")
    rec: dict = {"schema_version": SCHEMA_VERSION, "kind": kind}
    for k, v in fields.items():
        tag = table.get(k)
        if tag == "int":
            v = int(v)
        elif tag == "num":
            v = float(v)
        rec[k] = v
    errs = validate_record(rec)
    if errs:
        raise ValueError(f"bad {kind} record: " + "; ".join(errs))
    return rec


def validate_record(rec: dict, index: int | None = None) -> List[str]:
    """Shape-check one record against its kind's field table.

    Returns a list of error strings (empty = valid).  ``index`` prefixes
    errors with the record's position for stream-level reports.
    """
    where = f"record {index}: " if index is not None else ""
    if not isinstance(rec, dict):
        return [f"{where}not a JSON object"]
    kind = rec.get("kind")
    table = STREAM_KINDS.get(kind)
    if table is None:
        return [f"{where}unknown kind {kind!r}"]
    errs = []
    ver = rec.get("schema_version")
    if ver != SCHEMA_VERSION:
        errs.append(f"{where}schema_version {ver!r} != {SCHEMA_VERSION}")
    for k, tag in table.items():
        if k not in rec:
            errs.append(f"{where}missing key {k!r}")
        elif not _type_ok(tag, rec[k]):
            errs.append(f"{where}key {k!r}: expected {tag}, "
                        f"got {type(rec[k]).__name__}")
    for k in rec:
        if k not in table:
            errs.append(f"{where}unexpected key {k!r} for kind {kind!r} "
                        "(schema change? bump SCHEMA_VERSION)")
    return errs


def validate_stream(records: Iterable[dict]) -> List[str]:
    """Validate a whole stream: per-record shape plus the monotone stream
    clock — ``t`` non-decreasing and ``chunk`` strictly increasing per
    ``(kind, group)``.  ``resume`` records mark the seam of a restarted
    run, so their chunk clock is only required non-decreasing (a run
    killed twice at the same boundary resumes there twice)."""
    errs: List[str] = []
    last: Dict[tuple, tuple] = {}
    for i, rec in enumerate(records):
        rec_errs = validate_record(rec, index=i)
        errs.extend(rec_errs)
        if rec_errs:
            continue
        key = (rec["kind"], rec["group"])
        t, chunk = rec["t"], rec["chunk"]
        if key in last:
            pt, pc = last[key]
            if t < pt:
                errs.append(f"record {i}: t went backwards for {key}: "
                            f"{pt} -> {t}")
            strict = rec["kind"] != "resume"
            if chunk < pc or (strict and chunk == pc):
                errs.append(f"record {i}: chunk not increasing for {key}: "
                            f"{pc} -> {chunk}")
        last[key] = (t, chunk)
    return errs


def jsonl_line(record: dict) -> str:
    """One stream record as a canonical JSONL line (sorted keys, so CI
    diffs are order-stable)."""
    return json.dumps(record, sort_keys=True)


def write_stream_jsonl(result_or_records, path: str) -> int:
    """Write a run's stream records as JSONL; returns the count."""
    records = getattr(result_or_records, "stream_records",
                      result_or_records)
    with open(path, "w") as f:
        for rec in records:
            f.write(jsonl_line(rec) + "\n")
    return len(records)


def read_stream_jsonl(path: str) -> List[dict]:
    """Parse a stream JSONL file.  A truncated final line (a writer
    mid-append) is ignored — the tailing reader's contract."""
    records: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return records
