"""The granite prefill cell on the CPU, at `conftest.tiny_cell`'s size (2
layers, d_model 64, 4 experts top-2, two prompts of 128 tokens, float32
activations, the configuration's bfloat16 weights): the plain reference
against the port, the control and the faults judged not correct through
the harness, the FLOP and byte counts against hand counts, the readers on
a hand-made trace, and what the reference loads."""
from __future__ import annotations

import math

import pytest
import torch

from portbench import harness, layers, prefill_layers
from portbench.entries import prefill as entry_mod
from portbench.reference import granite
from portbench.roofline import bp_slot_step, prefill
from portbench.tests.conftest import tiny_cell
from portbench.tracing import Trace

CELL = "granite-moe-1b-a400m.prefill_4k"
H100 = "NVIDIA H100 80GB HBM3"


def _entry(seed: int):
    entry = harness.make_entry(tiny_cell(CELL), seed, "cpu")
    entry.setup()
    return entry


def _all_positions(entry):
    """The port's logits at every position of every prompt, through the
    function the step wraps."""
    from repro_torch.models import get_model
    with torch.inference_mode():
        logits, H, _ = get_model(entry.model).logits(
            entry.weights, {"tokens": entry.tokens},
            activ_dtype=torch.float32, remat="none", router_H=entry.H0)
    return logits, H


@pytest.mark.parametrize("seed", [0, 5, 2_147_483_999])
def test_reference_against_the_port(seed):
    """Float32 arithmetic on both sides over the same bfloat16 weights:
    every prompt's last-position logits within 1e-5 of its largest (the
    sums' rounding reads ~3e-7; the float8 control ~0.2)."""
    entry = _entry(seed)
    idx = entry.sample()
    got = entry.compare(entry.answers(entry.run(), idx),
                        entry.reference(idx))
    assert got["row_gap_max"] < 1e-5, got
    assert entry.weights["embed"]["table"].dtype == torch.bfloat16


def test_the_tiny_cell_drops_by_capacity():
    """Some expert of some prompt overflows its capacity (the drops are
    exercised): a queue the gate leaves exceeds B x cap x (1.25 - 1) / 1.25,
    so some row held more than ceil(S k / E x 1.25) of one expert."""
    entry = _entry(0)
    _, H = _all_positions(entry)
    S, k, E = entry.S, entry.model.top_k, entry.model.n_experts
    assert float(H.max()) > entry.B * S * k / E * 0.25


def test_experts_keep_their_first_assignments():
    """Capacity 1 (S k / E x 0.5 = 1): in each row each expert computes
    only its first assignment in (token, pick) order; the rest add
    nothing.  Two rows, each its own group."""
    d, ff, E = 4, 3, 2
    gen = torch.Generator().manual_seed(0)
    gate_w, up_w = (torch.randn(E, d, ff, generator=gen) for _ in range(2))
    down_w = torch.randn(E, ff, d, generator=gen)
    x = torch.randn(2, 2, d, generator=gen)
    picks = torch.tensor([[1, 0], [0, 1]]).expand(2, 2, 2)
    w = torch.tensor([[0.75, 0.25], [0.5, 0.5]]).expand(2, 2, 2)
    out = granite.experts(x, picks, w, gate_w, up_w, down_w, 0.5)

    def swiglu(h, e):
        return (torch.nn.functional.silu(h @ gate_w[e]) * (h @ up_w[e])) \
            @ down_w[e]
    for b in range(2):
        want = 0.75 * swiglu(x[b, 0], 1) + 0.25 * swiglu(x[b, 0], 0)
        torch.testing.assert_close(out[b, 0], want)
        assert (out[b, 1] == 0).all()


@pytest.mark.parametrize("fault", sorted(entry_mod.FAULTS))
def test_a_fault_is_not_correct(fault):
    """The harness's run with the timed path broken underneath."""
    with entry_mod.FAULTS[fault]():
        out = harness.run_cell(CELL, 8, 0.01, False, device="cpu",
                               cell=tiny_cell(CELL))
    assert not out.correct and out.failed == out.attempted, out.checks


def test_the_altered_answer_is_one_prompts_last_row():
    entry = _entry(4)
    real = entry.run()
    with entry_mod.altered_answer():
        bad = entry.run()
    differ = (bad != real).flatten(1).any(-1)
    assert differ.tolist() == [b == entry.B // 2 for b in range(entry.B)]


def test_the_late_fault_is_confined_past_the_middle():
    """Positions before S / 2 read exactly as without the fault; every
    prompt's last row differs."""
    entry = _entry(6)
    real, _ = _all_positions(entry)
    with entry_mod.late_keys_only():
        bad, _ = _all_positions(entry)
    h = entry.S // 2
    assert torch.equal(bad[:, :h], real[:, :h])
    assert (bad[:, -1] != real[:, -1]).any(-1).all()


def test_the_control_is_not_correct():
    entry = _entry(3)
    idx = entry.sample()
    ref = entry.reference(idx)
    checks, failed = harness.judge(entry, [entry.control(idx)], ref)
    assert failed == 1, checks
    checks, failed = harness.judge(entry, [ref], ref)
    assert failed == 0, checks


def test_the_weights_are_the_programs_tree():
    """The benchmark's weights, in the port's layout, have the tree and the
    shapes of the port's own init; at full size 1,334,628,352 of them."""
    from repro_torch.models import get_model, split_tree
    entry = _entry(1)
    own, _ = split_tree(get_model(entry.model).init(
        torch.Generator().manual_seed(0)))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    assert shapes(entry.weights) == shapes(own)
    full = harness.cell_spec(CELL)["config_data"]
    assert sum(math.prod(s) for _, s, _ in granite.layout(full)) == \
        1_334_628_352


def test_the_port_section_is_the_published_config():
    for cfg in (harness.cell_spec(CELL)["config_data"],
                tiny_cell(CELL)["config_data"]):
        port = cfg["port"]
        assert (port["n_layers"], port["d_model"], port["n_heads"],
                port["n_kv_heads"], port["d_ff"], port["vocab"],
                port["n_experts"], port["top_k"]) == (
            cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["intermediate_size"], cfg["vocab_size"],
            cfg["num_local_experts"], cfg["num_experts_per_tok"])
        assert port["head_dim"] * port["n_heads"] == cfg["hidden_size"]


def test_the_prompts_fit_the_published_context():
    cell = harness.cell_spec(CELL)
    assert cell["traffic_data"]["seq_len"] <= \
        cell["config_data"]["max_position_embeddings"]


#: The cell's tokens a prefill: 32 prompts of 4,096.
B, S = 32, 4_096
PAIRS = S * (S + 1) // 2
FLOPS = 2 * 15_761_408 * 24 * B * S + 24 * 4 * 16 * 64 * B * PAIRS \
    + 2 * 1_024 * 49_155 * B


def test_prefill_flops_match_the_hand_count():
    port = harness.cell_spec(CELL)["config_data"]["port"]
    # Per token and layer: q, k, v 1,024 x (16 + 2 x 8) x 64 = 2,097,152;
    # o 16 x 64 x 1,024 = 1,048,576; router 1,024 x 32 = 32,768; 8 experts
    # x 3 x 1,024 x 512 = 12,582,912; 15,761,408 weights, 2 FLOPs each.
    # Causal attention: 4 x 16 heads x 64 over 4,096 x 4,097 / 2 pairs a
    # prompt; the head 2 x 1,024 x 49,155 for each prompt's last row.
    assert prefill.prefill_flops(port, B, S) == FLOPS == 125_560_147_869_696


def test_kernel_counts_match_the_hand_counts():
    # Flash: q and o 32 x 4,096 x 16 x 64 bf16 each, k and v 32 x 4,096 x 8
    # x 64.
    assert prefill.flash_bytes(B, 16, 8, S, S, 64, "bfloat16") \
        == 2 * 268_435_456 + 2 * 134_217_728
    # The gate over 131,072 tokens: logits x 32 bf16 (8,388,608), H 128,
    # steps 4 read; picks x 8 int64 (8,388,608), weights bf16 (2,097,152),
    # counts and H' 256, steps 4 written.
    assert prefill.gate_bytes(B * S, 32, 8, "bfloat16") == 18_874_760
    peaks = {"hbm_bytes_per_s": 3.35e12, "bf16_dense_flops_per_s": 9.89e14}
    shapes = {"B": B, "H": 16, "KH": 8, "S": S, "T": S, "D": 64,
              "dtype": "bfloat16"}
    assert prefill.flash_least_seconds(shapes, peaks) == pytest.approx(
        4 * B * 16 * 64 * PAIRS / 9.89e14)
    assert prefill.gate_least_seconds(
        {"T": B * S, "E": 32, "k": 8, "dtype": "bfloat16"}, peaks) == \
        pytest.approx(18_874_760 / 3.35e12)


MS = 1_000_000
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13,
         "bf16_dense_flops_per_s": 9.89e14}


def _reading(device, window=(0, 100 * MS), prefills=2, peaks=PEAKS):
    """A hand-made traced window of granite's prefills."""
    cfg = harness.cell_spec(CELL)["config_data"]
    launches = prefill.prefill_launches(cfg, B, S, "bfloat16", prefills)
    return layers.Reading(Trace(device, [], *window), 0, launches, peaks)


def test_the_readers_on_a_hand_made_trace():
    # Two flash launches of 4.8 ms, two gates of 0.05 ms, other work of 30
    # ms and a copy of 10 ms, over a window of 100 ms of 2 prefills.
    dev = [("void flash_attention_sm90_kernel<64>", 0, 4_800_000),
           ("void bp_topk_route_rows_kernel<bf16>", 9 * MS, 9 * MS + 50_000),
           ("nvjet_gemm", 10 * MS, 40 * MS),
           ("Memcpy DtoD", 40 * MS, 50 * MS),
           ("void flash_attention_sm90_kernel<64>", 50 * MS, 54_800_000),
           ("void bp_topk_route_rows_kernel<bf16>", 59 * MS,
            59 * MS + 50_000)]
    r = _reading(dev)
    flash = 4 * B * 16 * 64 * PAIRS / 9.89e14
    assert prefill_layers.flash_roofline(r) == pytest.approx(
        100 * flash / 4.8e-3)
    assert prefill_layers.gate_roofline(r) == pytest.approx(
        100 * 18_874_760 / 3.35e12 / 50e-6)
    assert prefill_layers.remainder_ms(r) == pytest.approx(40.0 / 2)
    assert prefill_layers.mfu(r) == pytest.approx(
        100 * 2 * FLOPS / (0.1 * 9.89e14))
    for name in ("mfu.prefill", "flash_attention_roofline.prefill",
                 "bp_topk_route_roofline.prefill", "prefill.remainder_ms"):
        assert harness.metric_reader(name)(r) is not None


def test_the_readers_with_nothing_to_read():
    dev = [("void flash_attention_sm90_kernel<64>", 0, 4_800_000),
           ("void bp_topk_route_rows_kernel<bf16>", 9 * MS, 9 * MS + 50_000)]
    for r in (_reading([]), _reading(dev, peaks=None)):
        for read in (prefill_layers.flash_roofline,
                     prefill_layers.gate_roofline, prefill_layers.mfu):
            assert read(r) is None
    assert prefill_layers.remainder_ms(_reading([])) is None


def test_the_existing_readers_ignore_the_bf16_peak():
    """The card's row of `peaks.json` carries the bf16 peak; the slot-step
    roofline reads the same with and without it."""
    row = harness.load_json(harness.HERE / "roofline" / "peaks.json")[H100]
    assert row["bf16_dense_flops_per_s"] == 9.89e14 and "bf16" in \
        row["source"]
    plain = {k: v for k, v in row.items() if k != "bf16_dense_flops_per_s"}
    shapes = {"B": 1512, "N": 16, "E": 51, "NC": 4, "regulated": True}
    tr = Trace([("bp_slot_step_kernel_SlotStepArgs", 0, 27_400)], [], 0,
               MS)
    assert layers.slot_kernel_roofline(layers.Reading(tr, 1, [(shapes, 1)],
                                                      plain)) == \
        layers.slot_kernel_roofline(layers.Reading(tr, 1, [(shapes, 1)], row))
    assert bp_slot_step.least_seconds(shapes, row) == \
        bp_slot_step.least_seconds(shapes, plain)


def test_the_reference_loads_nothing_of_the_program():
    from portbench.tests.test_portbench_imports import loaded
    mods = loaded("""
from portbench.reference import granite
from portbench.roofline import prefill
""")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_cell_loads_no_jax():
    from portbench.tests.test_portbench_imports import loaded
    mods = loaded(f"""
from portbench import harness
from portbench.tests.conftest import tiny_cell
harness.run_cell({CELL!r}, 3, 0.01, True, device="cpu",
                 cell=tiny_cell({CELL!r}))
""")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
