"""The least work of a model's prefill and of its kernels, from the
configuration file's `port` sizes and the traffic's shapes alone (never
from the program).

Model FLOPs of one prefill of B x S tokens (`prefill_flops`), counting
each multiply-add as 2:

  * per token and layer, 2 x the active weights outside the embedding:
    the query, key and value projections d (H + 2 KH) Dh, the output
    projection H Dh d, the router d E and top_k experts of 3 d d_ff each
    (every layer an MoE layer, as the port's `moe` family stacks them);
  * per layer, causal attention: 4 H Dh over the S (S + 1) / 2 pairs of a
    query and a key at or before it, per row of the batch;
  * the output head for the positions whose logits the step returns (the
    last of each row): 2 d V each.

Norms, RoPE, the softmax and the gate's arithmetic are left out, as MFU
counts them.  Capacity drops are not subtracted: the model's work is
every token's top_k experts.

A flash attention launch (`flash_least_seconds`) reads q, k and v and
writes o once each, and does the causal attention's 4 H Dh per pair; the
gate (`gate_bytes`, `bp_topk_route`) reads the router logits [T, E], H
[E] and the step counter, and writes the picks [T, k] as int64, their
weights [T, k] in the logits' dtype, the counts and H' [E] float32 and
the new step counter; its workspace is scratch and not counted.
"""
from __future__ import annotations

I32 = F32 = 4
I64 = 8
#: Bytes of an element, and the peak (`roofline/peaks.json` key) of a
#: product, by the activations' dtype.
ELEMENT = {"bfloat16": 2, "float32": 4}
PEAK = {"bfloat16": "bf16_dense_flops_per_s", "float32": "f32_flops_per_s"}


def attention_flops(B: int, H: int, S: int, D: int) -> int:
    """Causal self-attention of B rows of S queries over H heads."""
    return 4 * B * H * D * (S * (S + 1) // 2)


def prefill_flops(port: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill (module docstring); ``port`` is the
    configuration file's `port` section."""
    d, H, KH, Dh = (port[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                      "head_dim"))
    moe = d * port["n_experts"] + port["top_k"] * 3 * d * port["d_ff"]
    per_token = d * (H + 2 * KH) * Dh + H * Dh * d + moe
    L = port["n_layers"]
    return (2 * per_token * L * B * S + L * attention_flops(B, H, S, Dh)
            + 2 * d * port["vocab"] * B)


def flash_bytes(B: int, H: int, KH: int, S: int, T: int, D: int,
                dtype: str) -> int:
    e = ELEMENT[dtype]
    return 2 * B * S * H * D * e + 2 * B * T * KH * D * e


def flash_least_seconds(shapes: dict, peaks: dict) -> float:
    """The larger of operations over the dtype's peak and bytes over the
    memory's."""
    flops = attention_flops(shapes["B"], shapes["H"], shapes["S"],
                            shapes["D"])
    nbytes = flash_bytes(shapes["B"], shapes["H"], shapes["KH"],
                         shapes["S"], shapes["T"], shapes["D"],
                         shapes["dtype"])
    return max(flops / peaks[PEAK[shapes["dtype"]]],
               nbytes / peaks["hbm_bytes_per_s"])


def gate_bytes(T: int, E: int, k: int, dtype: str) -> int:
    e = ELEMENT[dtype]
    read = T * E * e + E * F32 + I32
    written = T * k * I64 + T * k * e + 2 * E * F32 + I32
    return read + written


def gate_least_seconds(shapes: dict, peaks: dict) -> float:
    """Bytes over the memory's peak: the gate's few operations a logit
    (an exponential, a subtraction, k comparisons) are far below it."""
    return gate_bytes(shapes["T"], shapes["E"], shapes["k"],
                      shapes["dtype"]) / peaks["hbm_bytes_per_s"]


def prefill_launches(config: dict, B: int, S: int, dtype: str,
                     prefills: int) -> list:
    """[(shapes, launches)] of ``prefills`` prefills: the flash kernel and
    the gate once a layer, and the prefill itself with its model FLOPs."""
    port = config["port"]
    L = port["n_layers"]
    return [({"kernel": "flash_attention", "B": B, "H": port["n_heads"],
              "KH": port["n_kv_heads"], "S": S, "T": S,
              "D": port["head_dim"], "dtype": dtype}, L * prefills),
            ({"kernel": "bp_topk_route", "T": B * S, "E": port["n_experts"],
              "k": port["top_k"], "dtype": dtype}, L * prefills),
            ({"kernel": "prefill", "flops": prefill_flops(port, B, S),
              "dtype": dtype}, prefills)]
