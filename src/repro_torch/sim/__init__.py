"""Trace simulator and arrival laws."""
from . import workload
from .simulator import (SimResult, simulate, sweep_rates, build_step,
                        make_step, make_trace_runner)
from .workload import (poisson_arrivals, bernoulli_batch_arrivals,
                       constant_arrivals)

__all__ = ["SimResult", "simulate", "sweep_rates", "build_step",
           "make_step", "make_trace_runner", "workload",
           "poisson_arrivals", "bernoulli_batch_arrivals",
           "constant_arrivals"]
