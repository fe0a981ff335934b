"""What the harness and the reference load: no module whose top-level name
is `jax`, `jaxlib`, `flax` or `repro` (the part before the first dot,
compared whole: the port's name, `repro_torch`, begins with `repro`), and
for the reference nothing of the program either."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench.harness import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_reference_package():
    body = """
from portbench import harness, tracing, layers
cell = harness.cell_spec("paper_grid.trace_pi3")
cell["config_data"]["T"] = 64
out = harness.run_cell("paper_grid.trace_pi3", 3, 0.01, False,
                       device="cpu", cell=cell)
for name in ("atlas_hull.fleet", "paper_grid.trace_pi3bar"):
    harness.make_entry(harness.cell_spec(name), 1, "cpu").setup()
for m in harness.load_json(harness.ROOT / "BENCHMARK.json")["per_layer"]:
    harness.metric_reader(m["name"])
"""
    mods = loaded(body)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    body = """
from portbench.reference import fleet, noise, slot, trace
from portbench.roofline import bp_slot_step
"""
    mods = loaded(body)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_run_line_checks_by_whole_top_level_names():
    from portbench import run
    assert "repro" in run.BARRED and "repro_torch" not in run.BARRED
    assert set(run.barred_modules()) <= set(run.BARRED)
