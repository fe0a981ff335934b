"""Core library: graph, capacity LP, batched queue state, slot policies."""
from .graph import (Graph, ComputeProblem, grid_graph, line_graph,
                    triangle_graph, paper_grid_problem)
from .capacity import capacity_upper_bound, CapacityResult
from .queues import (DriftStats, NetState, StaticProblem, init_state,
                     kahan_add, drift_verdict_update)
from .policies import PolicyConfig, slot_step, slot_step_ref
from .regulator import regulator_push

__all__ = [
    "Graph", "ComputeProblem", "grid_graph", "line_graph", "triangle_graph",
    "paper_grid_problem", "capacity_upper_bound", "CapacityResult",
    "DriftStats", "NetState", "StaticProblem", "init_state", "kahan_add",
    "drift_verdict_update", "PolicyConfig", "slot_step", "slot_step_ref",
    "regulator_push",
]
