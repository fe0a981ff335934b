"""The least work of a prefill of a model with DeepSeek-V3's block
(latent attention, shared experts, leading dense layers) and of its
kernels, from the configuration file's `port` sizes and the traffic's
shapes alone (never from the program).

Model FLOPs of one prefill of B x S tokens (`prefill_flops`), each
multiply-add counted as 2:

  * per token, 2 x the active weights outside the embedding: in every
    layer the latent attention's q d H (Dn + Dr), kv_a d (R + Dr), kv_b
    R H (Dn + Dv) and o H Dv d; in each leading dense layer a SwiGLU of
    3 d Fd; in each MoE layer the router d E, top_k experts of 3 d F each
    and the shared experts' 3 d (n_shared F);
  * per layer, causal attention: 2 H (Dn + Dr + Dv) over the S (S + 1) / 2
    pairs of a query and a key at or before it, per row of the batch;
  * the output head for each row's last position: 2 d V.

At Moonlight-16B-A3B's sizes that is 2,243,559,424 active weights a token;
at B = 8, S = 8,192 a prefill is 368.30 TFLOP (294.07 of them the linear
layers, 74.23 attention).  Norms, RoPE, the softmax and the gate's
arithmetic are left out, as MFU counts them; capacity drops are not
subtracted.

A flash attention launch (`flash_least_seconds`) reads q and k (D = Dn + Dr
columns) and v (Dv) and writes o (Dv) once each, and does the causal
attention's 2 H (D + Dv) per pair; the gate's bytes are
`roofline.prefill.gate_bytes` (the sigmoid mode moves the same).
"""
from __future__ import annotations

from portbench.roofline.prefill import ELEMENT, PEAK


def active_weights(port: dict) -> int:
    """Weights a token passes through outside the embedding and the
    head."""
    d, H, R = port["d_model"], port["n_heads"], port["kv_lora_rank"]
    Dn, Dr, Dv = (port[k] for k in ("qk_nope_head_dim", "qk_rope_head_dim",
                                    "v_head_dim"))
    attn = d * H * (Dn + Dr) + d * (R + Dr) + R * H * (Dn + Dv) + H * Dv * d
    Ld = port["first_dense_layers"]
    Lm = port["n_layers"] - Ld
    F = port["d_ff"]
    moe = (d * port["n_experts"] + port["top_k"] * 3 * d * F
           + 3 * d * port["n_shared_experts"] * F)
    return port["n_layers"] * attn + Ld * 3 * d * port["dense_d_ff"] \
        + Lm * moe


def attention_flops(B: int, H: int, S: int, D: int, Dv: int) -> int:
    """Causal self-attention of B rows of S queries over H heads, q and k
    D wide, v Dv."""
    return 2 * B * H * (D + Dv) * (S * (S + 1) // 2)


def prefill_flops(port: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill (module docstring); ``port`` is the
    configuration file's `port` section."""
    D = port["qk_nope_head_dim"] + port["qk_rope_head_dim"]
    attn = attention_flops(B, port["n_heads"], S, D, port["v_head_dim"])
    return (2 * active_weights(port) * B * S + port["n_layers"] * attn
            + 2 * port["d_model"] * port["vocab"] * B)


def flash_bytes(B: int, H: int, KH: int, S: int, T: int, D: int, Dv: int,
                dtype: str) -> int:
    e = ELEMENT[dtype]
    return B * S * H * (D + Dv) * e + B * T * KH * (D + Dv) * e


def flash_least_seconds(shapes: dict, peaks: dict) -> float:
    """The larger of operations over the dtype's peak and bytes over the
    memory's."""
    flops = attention_flops(shapes["B"], shapes["H"], shapes["S"],
                            shapes["D"], shapes["Dv"])
    nbytes = flash_bytes(shapes["B"], shapes["H"], shapes["KH"],
                         shapes["S"], shapes["T"], shapes["D"],
                         shapes["Dv"], shapes["dtype"])
    return max(flops / peaks[PEAK[shapes["dtype"]]],
               nbytes / peaks["hbm_bytes_per_s"])


def prefill_launches(config: dict, B: int, S: int, dtype: str,
                     prefills: int) -> list:
    """[(shapes, launches)] of ``prefills`` prefills: the flash kernel once
    a layer, the gate once an MoE layer, and the prefill itself with its
    model FLOPs."""
    port = config["port"]
    L, H = port["n_layers"], port["n_heads"]
    Lm = L - port["first_dense_layers"]
    return [({"kernel": "flash_attention", "B": B, "H": H, "KH": H, "S": S,
              "T": S,
              "D": port["qk_nope_head_dim"] + port["qk_rope_head_dim"],
              "Dv": port["v_head_dim"], "dtype": dtype}, L * prefills),
            ({"kernel": "bp_topk_route", "T": B * S, "E": port["n_experts"],
              "k": port["top_k"], "dtype": dtype}, Lm * prefills),
            ({"kernel": "prefill", "flops": prefill_flops(port, B, S),
              "dtype": dtype}, prefills)]
