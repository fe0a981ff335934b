"""Core library: graph, capacity LP, batched queue state, slot policies,
the backpressure MoE router.

Every name of the reference's `repro.core.__all__` is here under its
name, plus the port's own (`DriftStats`, `kahan_add`,
`drift_verdict_update`, `slot_step_ref`)."""
from .graph import (Graph, ComputeProblem, grid_graph, line_graph,
                    triangle_graph, paper_grid_problem)
from .capacity import (capacity_upper_bound, single_node_capacity,
                       multi_stream_capacity, CapacityResult,
                       MultiStreamResult)
from .queues import (DriftStats, NetState, StaticProblem, init_state,
                     kahan_add, drift_verdict_update)
from .policies import (PolicyConfig, slot_step, slot_step_ref, bp_route_slot,
                       computation_slot)
from .router import (RouterConfig, RouterState, RouterOut, init_router_state,
                     route)
from .regulator import regulator_push

__all__ = [
    "Graph", "ComputeProblem", "grid_graph", "line_graph", "triangle_graph",
    "paper_grid_problem", "capacity_upper_bound", "single_node_capacity",
    "CapacityResult", "multi_stream_capacity", "MultiStreamResult",
    "DriftStats", "NetState", "StaticProblem", "init_state", "kahan_add",
    "drift_verdict_update", "PolicyConfig", "slot_step", "slot_step_ref",
    "bp_route_slot", "computation_slot",
    "RouterConfig", "RouterState", "RouterOut", "init_router_state", "route",
    "regulator_push",
]
