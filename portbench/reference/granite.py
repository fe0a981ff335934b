"""granite-moe-1b-a400m's prefill in plain PyTorch, float32, as the port
runs it: the weights drawn from the seed, and the forward pass that the
program's timed prefill is held to: each prompt's logits at its last
position, the answer the prefill step returns.

The model (the configuration file's `port` section and published keys;
its `departures` say where the port's block differs from the published
granite): token embedding (tied to the output head); per layer an RMSNorm
(eps 1e-6, gain 1 + g), grouped-query attention with GPT-NeoX RoPE
(theta from the file) and scale 1/sqrt(head_dim), causal, a residual
add, a second RMSNorm and a mixture of experts, a residual add; a final
RMSNorm and the logits of each row's last position.

The mixture of experts is the port's backpressure gate with a static
capacity:

  * router logits x W_r [E]; probs = softmax over the experts;
  * the k experts of largest probs - H / max(C_e, 1), C_e = T k / E the
    per-step capacity of the call's T tokens (all rows of the batch), the
    lowest expert first on ties;
  * weights: the picked probs over their sum (at least 1e-9);
  * each row of the batch is one group: an expert keeps the first
    ceil(S k / E x capacity_factor) of its assignments in the order
    (token, pick) and drops the rest (their output is 0);
  * an expert's output is SwiGLU(x) = (silu(x W_g) * (x W_u)) W_d, and a
    token's is the weighted sum of its kept picks'.

Attention runs one row of the batch at a time, in blocks of query rows
against the keys up to the block's end, so that no [S, S] score tensor is
held; the experts run over every row at once.  The queues that the gate
leaves (H') are no answer of the step and are not computed.  ``precision`` names what
the forward computes in: "float32" (the reference) or "float8_e4m3fn"
(the control, the precision below the configuration's bfloat16
activations: both operands of every matrix product, the weights included,
and the residual stream between blocks rounded to e4m3 with one scale a
tensor, its largest magnitude at 448; products accumulated, and softmax,
norms, RoPE and the gate computed, in float32).

Plain torch only: no kernel, cache or batching of the port, and nothing
of the program is imported.  On a card, matrix products run with TF32
off.
"""
from __future__ import annotations

import contextlib
import math

import torch

#: Query rows of one attention block.
Q_BLOCK = 1024
#: Largest magnitude of float8 e4m3: a tensor's scale puts its own there.
E4M3_MAX = 448.0
PRECISIONS = ("float32", "float8_e4m3fn")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale, back in float32."""
    if x.numel() == 0:
        return x
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def dims(config: dict) -> dict:
    """The sizes the reference reads, by the published keys."""
    return {"L": config["num_hidden_layers"], "d": config["hidden_size"],
            "H": config["num_attention_heads"],
            "KH": config["num_key_value_heads"],
            "Dh": config["hidden_size"] // config["num_attention_heads"],
            "ff": config["intermediate_size"],
            "E": config["num_local_experts"],
            "k": config["num_experts_per_tok"], "V": config["vocab_size"]}


def layout(config: dict) -> list:
    """[(name, shape, scale)] of every weight, in the order they are drawn:
    a normal times the scale, 1/sqrt of the contraction size for the
    projections, 0.02 for the embedding and the router, 0.1 for the norm
    gains g (applied as 1 + g)."""
    z = dims(config)
    L, d, H, KH, Dh, ff, E, V = (z[n] for n in
                                 ("L", "d", "H", "KH", "Dh", "ff", "E", "V"))
    return [("embed", (V, d), 0.02),
            ("ln1", (L, d), 0.1),
            ("wq", (L, d, H, Dh), d ** -0.5),
            ("wk", (L, d, KH, Dh), d ** -0.5),
            ("wv", (L, d, KH, Dh), d ** -0.5),
            ("wo", (L, H, Dh, d), (H * Dh) ** -0.5),
            ("ln2", (L, d), 0.1),
            ("router", (L, d, E), 0.02),
            ("gate", (L, E, d, ff), d ** -0.5),
            ("up", (L, E, d, ff), d ** -0.5),
            ("down", (L, E, ff, d), ff ** -0.5),
            ("ln_f", (d,), 0.1)]


def weights(config: dict, gen: torch.Generator) -> dict:
    """{name: tensor} of every weight, drawn from ``gen`` on its device in
    one call in the configuration's `torch_dtype` and scaled in place; each
    tensor a view of one buffer."""
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
    `models.transformer` stack reads); no copy."""
    return {"embed": {"table": W["embed"]},
            "stack": {"layers": {
                "ln1": W["ln1"], "ln2": W["ln2"],
                "attn": {n: W[n] for n in ("wq", "wk", "wv", "wo")},
                "moe": {n: W[n] for n in ("router", "gate", "up", "down")}}},
            "ln_f": W["ln_f"]}


def rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * (1 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, n, D] at positions 0..S-1, the halves rotated (GPT-NeoX)."""
    S, _, D = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, wq, wk, wv, wo, theta: float,
              r=_identity) -> torch.Tensor:
    """One sequence: x [S, d] -> [S, d]; ``r`` rounds each product's
    operands."""
    S = x.shape[0]
    H, Dh = wq.shape[1], wq.shape[2]
    G = H // wk.shape[1]
    x = r(x)
    q = r(rope(torch.einsum("sd,dhk->shk", x, r(wq)), theta))
    k = r(rope(torch.einsum("sd,dhk->shk", x, r(wk)), theta))
    v = r(torch.einsum("sd,dhk->shk", x, r(wv)))
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)          # [H, S, Dh]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(Dh)
    out = torch.empty((H, S, Dh), dtype=torch.float32, device=x.device)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        s = q[:, q0:q1] @ k[:, :q1].transpose(1, 2)          # [H, n, q1]
        rows = torch.arange(q0, q1, device=x.device)[:, None]
        cols = torch.arange(q1, device=x.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, q0:q1] = r(torch.softmax(s, dim=-1)) @ v[:, :q1]
    return torch.einsum("hsk,hkd->sd", r(out), r(wo))


def gate(logits: torch.Tensor, H: torch.Tensor, k: int):
    """logits [T, E] float32, H [E] -> (picks [T, k], weights [T, k])."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    sel = probs - H / max(T * k / E, 1.0)
    picks = torch.sort(sel, dim=-1, descending=True, stable=True).indices[
        :, :k]
    w = torch.gather(probs, 1, picks)
    return picks, w / w.sum(-1, keepdim=True).clamp(min=1e-9)


def experts(x: torch.Tensor, picks, w, gate_w, up_w, down_w,
            capacity_factor: float, r=_identity) -> torch.Tensor:
    """The expert outputs of every row: x [B, S, d], picks and w [B, S, k];
    in each row each expert keeps its first ``cap`` assignments in (token,
    pick) order; ``r`` rounds each product's operands."""
    B, S, k = picks.shape
    E = gate_w.shape[0]
    cap = max(math.ceil(S * k / E * capacity_factor), 1)
    flat = picks.reshape(B, S * k)
    hot = torch.nn.functional.one_hot(flat, E).to(torch.int32)
    rank = (hot.cumsum(1) * hot).sum(-1) - 1            # within (row, e)
    del hot
    kept = rank < cap
    xs, ws = x.reshape(B * S, -1), w.reshape(B * S * k)
    out = torch.zeros_like(xs)
    for e in range(E):
        a = torch.nonzero(((flat == e) & kept).reshape(-1))[:, 0]
        if a.numel() == 0:
            continue
        t = a // k                                       # row b: b S + s
        h = r(xs[t])
        y = r(torch.nn.functional.silu(h @ r(gate_w[e])) * (h @ r(up_w[e]))) \
            @ r(down_w[e])
        out.index_add_(0, t, y * ws[a, None])
    return out.view_as(x)


def forward(config: dict, W: dict, tokens: torch.Tensor, H0: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """tokens [B, S], H0 [L, E] -> the logits of each row's last position
    [B, V], float32, on the weights' device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of "
                         f"{PRECISIONS}")
    r = _identity if precision == "float32" else e4m3
    with no_tf32():
        return _forward(config, dims(config), W, tokens, H0, r)


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products on a card (TF32 off), restored after."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _forward(config, z, W, tokens, H0, r):
    theta = float(config["rope_theta"])
    cf = float(config["port"]["capacity_factor"])
    f32 = {n: t.to(torch.float32) for n, t in W.items()}
    B, S = tokens.shape
    x = f32["embed"][tokens]                                   # [B, S, d]
    for i in range(z["L"]):
        x = r(x)
        h = rmsnorm(x, f32["ln1"][i])
        x = r(x + torch.stack([attention(h[b], f32["wq"][i], f32["wk"][i],
                                         f32["wv"][i], f32["wo"][i], theta,
                                         r=r) for b in range(B)]))
        h = rmsnorm(x, f32["ln2"][i])
        picks, w = gate((r(h) @ r(f32["router"][i])).reshape(B * S, z["E"]),
                        H0[i].to(torch.float32), z["k"])
        x = x + experts(h, picks.view(B, S, -1), w.view(B, S, -1),
                        f32["gate"][i], f32["up"][i], f32["down"][i], cf, r)
    x = rmsnorm(r(x[:, -1]), f32["ln_f"])
    return r(x) @ r(f32["embed"]).T
