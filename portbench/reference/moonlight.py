"""Moonlight-16B-A3B's prefill in plain PyTorch, float32, as the port runs
it: the weights drawn from the seed, and the forward pass that the
program's timed prefill is held to: each prompt's logits at its last
position, the answer the prefill step returns.

The model is DeepSeek-V3's block (`model_type` deepseek_v3), its sizes the
configuration file's `port` section (which the benchmark's tests hold
equal to the published keys), its `departures` where the port differs:

  * token embedding, untied from the output head;
  * per layer an RMSNorm (eps `norm_eps`, gain 1 + g), multi-head latent
    attention, a residual add, a second RMSNorm and the layer's
    feed-forward, a residual add; a final RMSNorm and the logits of each
    row's last position;
  * latent attention: q = x W_q [H, Dn + Dr] (no q latent); [c, k_pe] =
    x W_kv_a [R + Dr]; c = RMSNorm(c); [k_nope, v] = c W_kv_b [H, Dn + Dv];
    RoPE (theta from the file, the port's half-split rotation) on q's last
    Dr columns and on k_pe, which every head shares; scores (q . k) /
    sqrt(Dn + Dr), causal; o = softmax . v [H, Dv], then W_o;
  * the first `first_dense_layers` layers' feed-forward is a SwiGLU of
    width `dense_d_ff`; every other layer's is the mixture of experts
    below plus the shared experts, one SwiGLU of width n_shared x d_ff
    that every token passes, unweighted.

The mixture of experts is the port's backpressure gate in its sigmoid
mode, with a static capacity:

  * router logits x W_r [E]; scores = sigmoid(logits);
  * the k experts of largest scores - H / max(C_e, 1), C_e = T k / E the
    per-step capacity of the call's T tokens (all rows of the batch), the
    lowest expert first on ties (H takes the slot of noaux_tc's
    selection-only bias; zero at every prefill);
  * weights: the picked scores over their sum (at least 1e-9) times
    `routed_scale`;
  * each row of the batch is one group, its experts keeping their first
    ceil(S k / E x capacity_factor) assignments in (token, pick) order
    (`granite.experts`).

With random weights the model is chaotic under the gate's picks: a
token whose 6th and 7th scores lie within rounding of each other may pick
either, that changes its row by the flipped expert's share, and through
attention every later row, layer after layer (in float32, a 2^-8
perturbation of the embedding alone moves the last rows' logits by a tenth
and more).  So `forward_held` holds the reference to given picks, the
program's, per MoE layer ("teacher-forced"): it computes every layer as
`forward` does, but dispatches the given picks, weighted by
the reference's own scores, and returns beside the logits each token's
and layer's shortfall, the amount by which its lowest given pick's score
falls short of the reference's own k-th largest: 0 when the picks are the
reference's own, a rounding's worth where a near-tie flipped, and large
where the program's gate chose otherwise.

Attention runs one row of the batch at a time, in blocks of query rows
against the keys up to the block's end; the dense feed-forward one row at
a time; the experts one expert at a time over every row.  The weights are
widened to float32 one layer at a time: two bfloat16 copies of the
16 billion weights and a float32 one would not fit on one card.
``precision`` as `granite.forward`: "float32" (the reference) or
"float8_e4m3fn" (the control: every product's operands, the weights
included, and the residual stream between blocks rounded to e4m3 with one
scale a tensor; sums, softmax, norms, RoPE and the gate in float32).

Plain torch only: no kernel, cache or batching of the port, and nothing of
the program is imported.  On a card, matrix products run with TF32 off.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.granite import (PRECISIONS, Q_BLOCK, _identity,
                                         e4m3, experts, no_tf32, rope)

#: The weights of attention and its norms, one [L, ...] stack each.
ATTENTION = ("ln1", "ln2", "wq", "wkv_a", "kv_norm", "wkv_b", "wo")
#: The dense layers' SwiGLU, [first_dense_layers, ...] each.
DENSE = ("dense_gate", "dense_up", "dense_down")
#: The MoE layers' weights, [L - first_dense_layers, ...] each.
MOE = ("router", "gate", "up", "down", "shared_gate", "shared_up",
       "shared_down")


def dims(config: dict) -> dict:
    """The sizes the reference reads, from the file's `port` section."""
    p = config["port"]
    return {"L": p["n_layers"], "Ld": p["first_dense_layers"],
            "d": p["d_model"], "H": p["n_heads"], "R": p["kv_lora_rank"],
            "Dn": p["qk_nope_head_dim"], "Dr": p["qk_rope_head_dim"],
            "Dv": p["v_head_dim"], "Fd": p["dense_d_ff"], "F": p["d_ff"],
            "Fs": p["n_shared_experts"] * p["d_ff"], "E": p["n_experts"],
            "k": p["top_k"], "V": p["vocab"]}


def layout(config: dict) -> list:
    """[(name, shape, scale)] of every weight, in the order they are drawn:
    a normal times the scale, 1/sqrt of the contraction size for the
    projections, 0.02 for the embedding and the router, 0.1 for the norm
    gains g (applied as 1 + g)."""
    z = dims(config)
    L, Ld, d, H, R, Dn, Dr, Dv = (z[n] for n in ("L", "Ld", "d", "H", "R",
                                                 "Dn", "Dr", "Dv"))
    Lm, Fd, F, Fs, E, V = L - Ld, z["Fd"], z["F"], z["Fs"], z["E"], z["V"]
    return [("embed", (V, d), 0.02),
            ("head", (d, V), d ** -0.5),
            ("ln1", (L, d), 0.1),
            ("ln2", (L, d), 0.1),
            ("wq", (L, d, H, Dn + Dr), d ** -0.5),
            ("wkv_a", (L, d, R + Dr), d ** -0.5),
            ("kv_norm", (L, R), 0.1),
            ("wkv_b", (L, R, H, Dn + Dv), R ** -0.5),
            ("wo", (L, H, Dv, d), (H * Dv) ** -0.5),
            ("dense_gate", (Ld, d, Fd), d ** -0.5),
            ("dense_up", (Ld, d, Fd), d ** -0.5),
            ("dense_down", (Ld, Fd, d), Fd ** -0.5),
            ("router", (Lm, d, E), 0.02),
            ("gate", (Lm, E, d, F), d ** -0.5),
            ("up", (Lm, E, d, F), d ** -0.5),
            ("down", (Lm, E, F, d), F ** -0.5),
            ("shared_gate", (Lm, d, Fs), d ** -0.5),
            ("shared_up", (Lm, d, Fs), d ** -0.5),
            ("shared_down", (Lm, Fs, d), Fs ** -0.5),
            ("ln_f", (d,), 0.1)]


def weights(config: dict, gen: torch.Generator) -> dict:
    """{name: tensor} of every weight, drawn from ``gen`` on its device in
    one call in the configuration's `torch_dtype` and scaled in place; each
    tensor a view of one buffer (the only copy of the weights: the program
    gets views of it, `program_params`)."""
    lay = layout(config)
    sizes = [math.prod(shape) for _, shape, _ in lay]
    flat = torch.randn(sum(sizes), generator=gen, device=gen.device,
                       dtype=getattr(torch, config["torch_dtype"]))
    out, at = {}, 0
    for (name, shape, scale), n in zip(lay, sizes):
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    return out


def program_params(W: dict) -> dict:
    """The same tensors in the port's parameter tree (the names its
    `models.transformer` stack reads: {"dense": [Ld, ...], "layers":
    [L - Ld, ...]}); views, no copy."""
    Ld = W["dense_gate"].shape[0]

    def block(sl):
        return {"ln1": W["ln1"][sl], "ln2": W["ln2"][sl],
                "attn": {n: W[n][sl] for n in ("wq", "wkv_a", "kv_norm",
                                                "wkv_b", "wo")}}
    dense = {**block(slice(0, Ld)),
             "mlp": {n: W["dense_" + n] for n in ("gate", "up", "down")}}
    moe = {**block(slice(Ld, None)),
           "moe": {**{n: W[n] for n in ("router", "gate", "up", "down")},
                   "shared": {n: W["shared_" + n]
                              for n in ("gate", "up", "down")}}}
    return {"embed": {"table": W["embed"], "head": W["head"]},
            "stack": {"dense": dense, "layers": moe}, "ln_f": W["ln_f"]}


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + g)


def attention(x: torch.Tensor, w: dict, z: dict, theta: float, eps: float,
              r=_identity) -> torch.Tensor:
    """One sequence's latent attention: x [S, d] -> [S, d]; ``w`` the
    layer's float32 weights; ``r`` rounds each product's operands."""
    S = x.shape[0]
    H, R, Dn, Dr = z["H"], z["R"], z["Dn"], z["Dr"]
    x = r(x)
    q = torch.einsum("sd,dhk->shk", x, r(w["wq"]))        # [S, H, Dn + Dr]
    kv = x @ r(w["wkv_a"])                                 # [S, R + Dr]
    c = rmsnorm(kv[:, :R], w["kv_norm"], eps)
    kvb = torch.einsum("sr,rhk->shk", r(c), r(w["wkv_b"]))  # [S, H, Dn + Dv]
    q = torch.cat([q[..., :Dn], rope(q[..., Dn:], theta)], dim=-1)
    k_pe = rope(kv[:, None, R:], theta).expand(S, H, Dr)
    k = r(torch.cat([kvb[..., :Dn], k_pe], dim=-1)).transpose(0, 1)
    v = r(kvb[..., Dn:]).transpose(0, 1)                   # [H, S, Dv]
    q = r(q).transpose(0, 1) / math.sqrt(Dn + Dr)
    out = torch.empty((H, S, v.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        s = q[:, q0:q1] @ k[:, :q1].transpose(1, 2)        # [H, n, q1]
        rows = torch.arange(q0, q1, device=x.device)[:, None]
        cols = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, q0:q1] = r(torch.softmax(s, dim=-1)) @ v[:, :q1]
    return torch.einsum("hsk,hkd->sd", r(out), r(w["wo"]))


def swiglu(h: torch.Tensor, g, u, dn, r=_identity) -> torch.Tensor:
    h = r(h)
    return r(torch.nn.functional.silu(h @ r(g)) * (h @ r(u))) @ r(dn)


def gate(logits: torch.Tensor, H: torch.Tensor, k: int, scale: float):
    """logits [T, E] float32, H [E] -> (picks [T, k], weights [T, k])."""
    T, E = logits.shape
    scores = torch.sigmoid(logits)
    sel = scores - H / max(T * k / E, 1.0)
    picks = torch.sort(sel, dim=-1, descending=True, stable=True).indices[
        :, :k]
    w = torch.gather(scores, 1, picks)
    return picks, w / w.sum(-1, keepdim=True).clamp(min=1e-9) * scale


def forward(config: dict, W: dict, tokens: torch.Tensor, H0: torch.Tensor,
            precision: str = "float32"):
    """tokens [B, S], H0 [L - first_dense_layers, E] -> (the logits of
    each row's last position [B, V], float32, on the weights' device; the
    reference's own picks, one [B, S, k] tensor per MoE layer)."""
    logits, _, picks = _run(config, W, tokens, H0, precision, None)
    return logits, picks


def forward_held(config: dict, W: dict, tokens: torch.Tensor,
                 H0: torch.Tensor, picks: list, precision: str = "float32"):
    """`forward` held to ``picks`` (one [B, S, k] tensor of expert indices
    per MoE layer): (logits [B, V], shortfall [L - first_dense_layers, B,
    S] float32, how far each token's lowest given pick falls below the
    reference's k-th largest, per MoE layer; 0 where the picks are the
    reference's own) (module docstring)."""
    logits, short, _ = _run(config, W, tokens, H0, precision, picks)
    return logits, torch.stack(short)


def _run(config, W, tokens, H0, precision, picks):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of "
                         f"{PRECISIONS}")
    r = _identity if precision == "float32" else e4m3
    with no_tf32():
        return _forward(config, dims(config), W, tokens, H0, r, picks)


def _held(logits, H, k, scale, given):
    """The gate held to ``given`` picks [T, k]: (the given picks, their
    weights from the reference's own scores, how far the lowest given
    pick's sel falls below the reference's k-th largest, per token)."""
    T, E = logits.shape
    scores = torch.sigmoid(logits)
    sel = scores - H / max(T * k / E, 1.0)
    short = sel.topk(k, dim=-1).values[:, -1] - \
        torch.gather(sel, 1, given).amin(-1)
    w = torch.gather(scores, 1, given)
    return given, w / w.sum(-1, keepdim=True).clamp(min=1e-9) * scale, short


def _forward(config, z, W, tokens, H0, r, given=None):
    port = config["port"]
    theta, eps = float(port["rope_theta"]), float(port["norm_eps"])
    cf, scale = float(port["capacity_factor"]), float(port["routed_scale"])
    B, S = tokens.shape
    short, used = [], []
    x = W["embed"][tokens].to(torch.float32)                  # [B, S, d]
    for i in range(z["L"]):
        w = {n: W[n][i].to(torch.float32) for n in ATTENTION}
        x = r(x)
        h = rmsnorm(x, w["ln1"], eps)
        x = r(x + torch.stack([attention(h[b], w, z, theta, eps, r)
                               for b in range(B)]))
        h = rmsnorm(x, w["ln2"], eps)
        if i < z["Ld"]:
            f = [W[n][i].to(torch.float32) for n in DENSE]
            x = x + torch.stack([swiglu(h[b], *f, r=r) for b in range(B)])
            continue
        j = i - z["Ld"]
        m = {n: W[n][j].to(torch.float32) for n in MOE}
        logits = (r(h) @ r(m["router"])).reshape(B * S, z["E"])
        if given is None:
            picks, wts = gate(logits, H0[j].to(torch.float32), z["k"], scale)
        else:
            picks, wts, fell = _held(logits, H0[j].to(torch.float32),
                                     z["k"], scale,
                                     given[j].reshape(B * S, z["k"]))
            short.append(fell.view(B, S))
        used.append(picks.view(B, S, -1))
        y = experts(h, picks.view(B, S, -1), wts.view(B, S, -1), m["gate"],
                    m["up"], m["down"], cf, r)
        del m["gate"], m["up"], m["down"]
        x = x + (y + swiglu(h, m["shared_gate"], m["shared_up"],
                            m["shared_down"], r=r))
    x = rmsnorm(r(x[:, -1]), W["ln_f"].to(torch.float32), eps)
    return r(x) @ r(W["head"].to(torch.float32)), short, used
