"""Trace simulator and arrival laws."""
from . import workload
from .simulator import SimResult, simulate, sweep_rates
from .workload import poisson_arrivals

__all__ = ["SimResult", "simulate", "sweep_rates", "workload",
           "poisson_arrivals"]
