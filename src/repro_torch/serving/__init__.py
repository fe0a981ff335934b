"""Serving: trace-driven backpressure admission control on the fleet
substrate (port of `repro.serving`).

Public API:
  trace:      QueryClass, TraceSpec, TraceState, TRACES, register_trace,
              get_trace, list_traces, draw_arrivals
  admission:  AdmissionConfig, AdmissionState, DEFAULT_ADMISSION,
              admission_admit, admission_update
  scheduler:  make_serving_runner, ServingRunner, LAT_HORIZON, LAT_BINS
  engine:     ServingJob, ServingResult, run_serving
  report:     serving_report, jsonl_line, write_stream_jsonl

`run_serving(..., resilience=...)` runs are checkpointed and resumable
(`repro_torch.runtime.resilience`).
"""
from .trace import (QueryClass, TRACES, TraceSpec, TraceState, draw_arrivals,
                    get_trace, list_traces, register_trace)
from .admission import (AdmissionConfig, AdmissionState, DEFAULT_ADMISSION,
                        admission_admit, admission_update)
from .scheduler import (LAT_BINS, LAT_HORIZON, ServingRunner,
                        make_serving_runner)
from .engine import ServingJob, ServingResult, run_serving
from .report import jsonl_line, serving_report, write_stream_jsonl

__all__ = [
    "QueryClass", "TraceSpec", "TraceState", "TRACES", "register_trace",
    "get_trace", "list_traces", "draw_arrivals",
    "AdmissionConfig", "AdmissionState", "DEFAULT_ADMISSION",
    "admission_admit", "admission_update",
    "make_serving_runner", "ServingRunner", "LAT_HORIZON", "LAT_BINS",
    "ServingJob", "ServingResult", "run_serving",
    "serving_report", "jsonl_line", "write_stream_jsonl",
]
