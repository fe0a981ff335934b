"""CPU tests of the benchmark harness, its reference and its yardsticks.

    PYTHONPATH=src python -m pytest -q portbench/tests

Cells are cut to tiny sizes here (`tiny_cell`); the benchmark's own runs
use the files as they are."""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str, T: int = 256) -> dict:
    """The cell as the harness reads it, at a horizon of ``T`` slots and,
    for the fleet, three topology seeds of each family (one at each probe)
    and one compared lane of each (family, probe) stratum."""
    from portbench import harness
    cell = harness.cell_spec(name)
    cfg = cell["config_data"]
    cfg["T"] = T
    if "chunk" in cfg:
        cfg["chunk"] = T // 4
        cfg["topo_seeds"] = [0, 1, 2]
        cell["params"]["ref_per_stratum"] = 1
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
