"""The Moonlight prefill cell (`moonlight-16b-a3b.prefill_8k`) on the CPU
at a tiny cut of its configuration file (`tiny_mla`, this file's own: 2
layers, the dense one and one MoE, d_model 64, 4 heads of q/k 24 and v 16,
latent 32, 8 experts top-2 plus 1 shared, two prompts of 128 tokens,
float32 activations, the file's bfloat16 weights): the reference against
the port, the control and the faults judged not correct through the
harness (a gate fault by `pick_miss_share` alone), the recorded picks
tied to the compared runs, the FLOP and byte counts against hand counts at the cell's
shapes, the readers on hand-made traces and spans, the file's published
keys against the port's configuration, and what the reference loads."""
from __future__ import annotations

import pytest
import torch

from portbench import harness, layers
from portbench.entries import prefill_mla as entry_mod
from portbench.roofline import prefill, prefill_mla
from portbench.tracing import Trace

CELL = "moonlight-16b-a3b.prefill_8k"
#: The cut: published keys and the port's fields, each pair equal.
CUT = {"num_hidden_layers": ("n_layers", 2), "hidden_size": ("d_model", 64),
       "num_attention_heads": ("n_heads", 4),
       "num_key_value_heads": ("n_kv_heads", 4),
       "moe_intermediate_size": ("d_ff", 16), "vocab_size": ("vocab", 256),
       "n_routed_experts": ("n_experts", 8),
       "num_experts_per_tok": ("top_k", 2),
       "kv_lora_rank": ("kv_lora_rank", 32),
       "qk_nope_head_dim": ("qk_nope_head_dim", 16),
       "qk_rope_head_dim": ("qk_rope_head_dim", 8),
       "v_head_dim": ("v_head_dim", 16),
       "n_shared_experts": ("n_shared_experts", 1),
       "intermediate_size": ("dense_d_ff", 96)}


def tiny_mla() -> dict:
    cell = harness.cell_spec(CELL)
    cfg = cell["config_data"]
    for key, (field, n) in CUT.items():
        cfg[key] = cfg["port"][field] = n
    cfg["port"]["head_dim"] = 24
    cell["traffic_data"].update({"batch": 2, "seq_len": 128,
                                 "activ_dtype": "float32"})
    return cell


def _entry(seed: int):
    entry = harness.make_entry(tiny_mla(), seed, "cpu")
    entry.setup()
    return entry


@pytest.mark.parametrize("seed", [0, 2_147_483_999])
def test_reference_against_the_port(seed):
    """Float32 arithmetic on both sides over the same bfloat16 weights:
    every prompt's last-position logits within 1e-5 of its largest."""
    entry = _entry(seed)
    idx = entry.sample()
    got = entry.compare(entry.answers(entry.run(), idx),
                        entry.reference(idx))
    assert got["row_gap_max"] < 1e-5, got
    assert tuple(entry.H0.shape) == (1, 8)
    assert entry.weights["embed"]["head"].dtype == torch.bfloat16


def test_the_control_is_not_correct():
    entry = _entry(3)
    idx = entry.sample()
    ref = entry.reference(idx)
    checks, failed = harness.judge(entry, [entry.control(idx)], ref)
    assert failed == 1, checks
    checks, failed = harness.judge(entry, [ref], ref)
    assert failed == 0, checks


@pytest.mark.parametrize("fault", sorted(entry_mod.FAULTS))
def test_a_fault_is_not_correct(fault):
    """The harness's run with the timed path broken underneath."""
    with entry_mod.FAULTS[fault]():
        out = harness.run_cell(CELL, 8, 0.01, False, device="cpu",
                               cell=tiny_mla())
    assert not out.correct and out.failed == out.attempted, out.checks


def test_a_gate_fault_is_caught_by_the_miss_share():
    """One token in 64 taking its (k+1)-th best expert: the reference is
    held to those picks and weights them as the gate does, so the row gaps
    and `pick_margin` stay inside their limits; `pick_miss_share` alone
    reads it."""
    with entry_mod.FAULTS["seventh_for_sixth"]():
        out = harness.run_cell(CELL, 8, 0.01, False, device="cpu",
                               cell=tiny_mla())
    got = {name: (value, limit) for name, value, limit in out.checks}
    assert not out.correct and got["pick_miss_share"][0] > \
        got["pick_miss_share"][1], got
    assert all(v <= lim for name, (v, lim) in got.items()
               if name != "pick_miss_share"), got


def test_the_recorded_picks_are_the_compared_runs():
    """The run that records the gate's picks must repeat the last timed
    run bit for bit; a last run that differs stops the reference."""
    entry = _entry(5)
    idx = entry.sample()
    entry.run()
    entry._last = entry._last + 1
    with pytest.raises(RuntimeError, match="bit for bit"):
        entry.reference(idx)


def test_the_file_holds_the_published_model():
    """The configuration file's published keys and its `port` section
    agree, and both are the port's `moonlight-16b-a3b`."""
    from repro_torch.configs import get_config
    cfg = harness.cell_spec(CELL)["config_data"]
    port = cfg["port"]
    for key, (field, _) in CUT.items():
        assert cfg[key] == port[field], key
    assert port["first_dense_layers"] == cfg["first_k_dense_replace"]
    assert port["score_func"] == cfg["scoring_func"] == "sigmoid"
    assert port["routed_scale"] == cfg["routed_scaling_factor"]
    assert port["norm_eps"] == cfg["rms_norm_eps"]
    assert port["rope_theta"] == cfg["rope_theta"]
    assert port["tie_embeddings"] == cfg["tie_word_embeddings"] is False
    assert port["head_dim"] == cfg["qk_nope_head_dim"] + \
        cfg["qk_rope_head_dim"]
    assert cfg["q_lora_rank"] is None and cfg["n_group"] == 1 == \
        cfg["topk_group"]
    own = get_config("moonlight-16b-a3b")
    for field, value in port.items():
        assert getattr(own, field) == value, field
    cell = harness.cell_spec(CELL)
    assert cell["traffic_data"]["seq_len"] == cfg["max_position_embeddings"]


#: The cell's tokens a prefill: 8 prompts of 8,192.
B, S = 8, 8_192
PAIRS = S * (S + 1) // 2
#: Per token: MLA's q 2,048 x 16 x 192, kv_a 2,048 x 576, kv_b 512 x 16 x
#: 256 and o 16 x 128 x 2,048 in 27 layers (13,762,560 each); the dense
#: SwiGLU 3 x 2,048 x 11,264 once; in 26 MoE layers the router 2,048 x 64,
#: 6 experts of 3 x 2,048 x 1,408 and the shared 3 x 2,048 x 2,816
#: (69,337,088 each).
ACTIVE = 27 * 13_762_560 + 69_206_016 + 26 * 69_337_088
FLOPS = 2 * ACTIVE * B * S + 27 * 2 * 16 * (192 + 128) * B * PAIRS \
    + 2 * 2_048 * 163_840 * B


def test_prefill_flops_match_the_hand_count():
    port = harness.cell_spec(CELL)["config_data"]["port"]
    assert ACTIVE == prefill_mla.active_weights(port) == 2_243_559_424
    assert prefill_mla.prefill_flops(port, B, S) == FLOPS == \
        368_299_284_103_168
    assert round(FLOPS / 1e12, 2) == 368.30


def test_kernel_bounds_match_the_hand_counts():
    peaks = {"hbm_bytes_per_s": 3.35e12, "bf16_dense_flops_per_s": 9.89e14}
    shapes = {"B": B, "H": 16, "KH": 16, "S": S, "T": S, "D": 192,
              "Dv": 128, "dtype": "bfloat16"}
    # 2 x 16 heads x (192 + 128) a pair: 2.749e12 flops, 2.780 ms at 989
    # TFLOP/s; q, k (192) and v, o (128): 8 x 8,192 x 16 x 640 x 2 bytes.
    t = prefill_mla.flash_least_seconds(shapes, peaks)
    assert t == pytest.approx(2 * B * 16 * 320 * PAIRS / 9.89e14)
    assert round(t * 1e3, 3) == 2.780
    assert prefill_mla.flash_bytes(B, 16, 16, S, S, 192, 128,
                                   "bfloat16") == 1_342_177_280
    # The gate over 65,536 tokens, E = 64, k = 6: logits 8,388,608, H 256
    # and steps 4 read; picks 3,145,728, weights 786,432, counts and H' 512
    # and steps 4 written.
    assert prefill.gate_bytes(B * S, 64, 6, "bfloat16") == 12_321_544
    cfg = harness.cell_spec(CELL)["config_data"]
    got = prefill_mla.prefill_launches(cfg, B, S, "bfloat16", 2)
    assert [(s["kernel"], n) for s, n in got] == [
        ("flash_attention", 54), ("bp_topk_route", 52), ("prefill", 2)]


MS = 1_000_000
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13,
         "bf16_dense_flops_per_s": 9.89e14}


def _reading(device, prefills=2, peaks=PEAKS):
    cfg = harness.cell_spec(CELL)["config_data"]
    launches = prefill_mla.prefill_launches(cfg, B, S, "bfloat16", prefills)
    return layers.Reading(Trace(device, [], 0, 5_000 * MS), 0, launches,
                          peaks)


def test_the_readers_on_a_hand_made_trace():
    dev = [("void flash_attention_sm90_kernel<192, 128>", 0, 10 * MS),
           ("void bp_topk_route_rows_kernel<bf16, 64, true>", 20 * MS,
            20 * MS + 40_000),
           ("nvjet_gemm", 30 * MS, 900 * MS)]
    r = _reading(dev)
    read = {m: harness.metric_reader(m) for m in (
        "mfu.prefill_mla", "flash_attention_roofline.prefill_mla",
        "bp_topk_route_roofline.prefill_mla")}
    flash = 2 * B * 16 * 320 * PAIRS / 9.89e14
    assert read["flash_attention_roofline.prefill_mla"](r) == \
        pytest.approx(100 * flash / 10e-3)
    assert read["bp_topk_route_roofline.prefill_mla"](r) == pytest.approx(
        100 * 12_321_544 / 3.35e12 / 40e-6)
    assert read["mfu.prefill_mla"](r) == pytest.approx(
        100 * 2 * FLOPS / (5.0 * 9.89e14))
    for m in read.values():
        assert m(_reading([])) is None and m(_reading(dev, peaks=None)) \
            is None


def _span(name, d0, d1):
    return {"name": name, "id": 0, "parent": None, "run": 0, "t0_ns": 0,
            "t1_ns": 1, "d0_ns": int(d0 * MS), "d1_ns": int(d1 * MS)}


def test_the_latent_reader_on_hand_made_spans():
    """Two layers' latent spans of 3 and 5 ms in one prefill's span run;
    nothing to read without them."""
    import types
    read = harness.metric_reader("mla.latent_ms")
    spans = [_span("prefill.step", 0, 100), _span("mla.latent", 1, 4),
             _span("mla.core", 4, 9), _span("mla.latent", 10, 15)]
    assert read(types.SimpleNamespace(spans=spans)) == pytest.approx(8.0)
    assert read(types.SimpleNamespace(spans=spans[:1])) is None
    assert read(types.SimpleNamespace()) is None


def test_the_program_records_its_spans_and_counter():
    """The port's prefill opens `prefill.step`, per layer `mla.latent` and
    `mla.core`, per MoE layer `moe.shared`, and counts the expanded K and V
    bytes: 2 layers x 2 prompts x 128 x 4 heads x (24 + 16) x 4 bytes."""
    from repro_torch.obs import spans
    entry = _entry(1)
    with spans.recording() as rec:
        entry.run()
    names = [r["name"] for r in rec.spans()]
    assert {n: names.count(n) for n in set(names)} == {
        "prefill.step": 1, "mla.latent": 2, "mla.core": 2, "moe.shared": 1}
    assert rec.counters() == {"mla.kv_expanded_bytes":
                              2 * 2 * 128 * 4 * 40 * 4}


def test_the_reference_loads_nothing_of_the_program():
    from portbench.tests.test_portbench_imports import loaded
    mods = loaded("""
from portbench.reference import moonlight
from portbench.roofline import prefill_mla
""")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
