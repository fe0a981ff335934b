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


#: A model cell off the card: its published keys and the port's fields cut
#: far below the configuration's widths (2 layers, d_model 64, 4 experts
#: top-2), two prompts of 128 tokens, float32 activations.
TINY_MODEL = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": 32, "num_local_experts": 4,
              "num_experts_per_tok": 2, "vocab_size": 256}
TINY_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 16, "d_ff": 32, "vocab": 256, "n_experts": 4,
             "top_k": 2}
TINY_PROMPTS = {"batch": 2, "seq_len": 128, "activ_dtype": "float32"}


def tiny_cell(name: str, T: int = 256) -> dict:
    """The cell as the harness reads it, at a horizon of ``T`` slots and,
    for the fleet, three topology seeds of each family (one at each probe)
    and one compared lane of each (family, probe) stratum; a model cell at
    the sizes above."""
    from portbench import harness
    cell = harness.cell_spec(name)
    cfg = cell["config_data"]
    if "port" in cfg:
        cfg.update(TINY_MODEL)
        cfg["port"].update(TINY_PORT)
        cell["traffic_data"].update(TINY_PROMPTS)
        return cell
    cfg["T"] = T
    if "chunk" in cfg:
        cfg["chunk"] = T // 4
        cfg["topo_seeds"] = [0, 1, 2]
        cell["params"]["ref_per_stratum"] = 1
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
