"""Streaming telemetry plane (port of `repro.obs`).

`obs.schema` is the versioned stream-record contract every
``*_stream.jsonl`` writer emits against (a copy of the reference's, same
digest); `obs.emitter` the chunk-boundary transport the engines use
(device snapshot, side-stream copy to pinned memory, record assembly on a
worker thread); `obs.follow` the live view over the emitted files
(``python -m repro_torch.obs.follow``); `obs.spans` the run loops' spans
and counters on the profiler's clock, recorded only inside
``spans.recording()``.  The schema, follow and spans modules are pure
Python (spans touches torch only for device events).
"""
from .schema import (BLESSED_DIGESTS, SCHEMA_VERSION, STREAM_KINDS,
                     jsonl_line, make_record, read_stream_jsonl,
                     schema_digest, validate_record, validate_stream,
                     write_stream_jsonl)

__all__ = [
    "BLESSED_DIGESTS",
    "SCHEMA_VERSION",
    "STREAM_KINDS",
    "jsonl_line",
    "make_record",
    "read_stream_jsonl",
    "schema_digest",
    "validate_record",
    "validate_stream",
    "write_stream_jsonl",
]
