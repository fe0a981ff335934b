"""The paper's own experiment instance (§V): 4x4 grid, R=5, 4 computation
nodes; C in {2, 3}."""
from ..core.graph import paper_grid_problem


def problem(C: float = 2.0):
    return paper_grid_problem(C=C)
