"""Shared model building blocks: annotated params, norms, RoPE, embeddings.

Port of `repro.models.common`.  Params are nested dicts of tensors.  During
init every leaf is an `Annotated(value, axes)` carrying the reference's
logical axis names; `split_tree` separates the value tree from the axes
tree.  Random init draws from an explicit `torch.Generator`, on the
generator's device, as a normal truncated to +-2 sigma times the scale —
the reference's distribution, though not its (threefry) numbers: parity
tests carry the reference's weights across with `convert.params_from_numpy`.
Abstract init (the reference's ShapeDtypeStruct leaves) gives tensors on
the meta device: shapes and dtypes, no storage, for the dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Sequence

import torch


class Annotated(NamedTuple):
    value: Any                      # torch.Tensor (meta when abstract)
    axes: tuple                     # logical axis names, len == value.ndim


@dataclasses.dataclass
class Init:
    """Parameter factory: concrete (drawing from ``gen`` on the
    generator's device) or abstract (meta tensors, no generator).

    `prefix` prepends stacked-layer dims (logical axis "layers") to every
    param, to build the [L, ...] weight stacks in one shot.
    """
    gen: torch.Generator | None = None
    dtype: Any = torch.float32
    abstract: bool = False
    prefix: tuple = ()

    def __post_init__(self):
        if self.abstract and self.gen is not None:
            raise ValueError("an abstract Init draws nothing: pass no "
                             "generator")
        if not self.abstract and self.gen is None:
            raise ValueError("a concrete Init draws from a generator")

    def stacked(self, *ns: int) -> "Init":
        return dataclasses.replace(self, prefix=self.prefix + tuple(ns))

    def param(self, shape: Sequence[int], axes: Sequence[str | None],
              scale: float | None = None, kind: str = "normal") -> Annotated:
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not name shape {shape}")
        if scale is None:                    # the reference's fan-in rule
            fan_in = shape[0] if len(shape) >= 1 else 1
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        full_shape = tuple(self.prefix) + shape
        full_axes = ("layers",) * len(self.prefix) + tuple(axes)
        if self.abstract:
            return Annotated(torch.empty(full_shape, dtype=self.dtype,
                                         device="meta"), full_axes)
        dev = self.gen.device
        if kind == "zeros":
            v = torch.zeros(full_shape, dtype=self.dtype, device=dev)
        elif kind == "ones":
            v = torch.ones(full_shape, dtype=self.dtype, device=dev)
        else:
            v = torch.empty(full_shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.gen)
            # In place: a second float32 copy of a stacked leaf (23 GB for
            # gemma3-27b's local MLP stack) would not fit beside the rest.
            v = v.mul_(scale).to(self.dtype)
        return Annotated(v, full_axes)


def split_tree(tree):
    """(annotated tree of dicts) -> (value tree, axes tree); None (a
    parameter-free norm) stays None in both."""
    if tree is None:
        return None, None
    if isinstance(tree, Annotated):
        return tree.value, tree.axes
    values, axes = {}, {}
    for k, v in tree.items():
        values[k], axes[k] = split_tree(v)
    return values, axes


def tree_leaves(tree) -> list:
    """The leaves of a value tree (nested dicts), keys in sorted order:
    `jax.tree.leaves`'s order over the reference's dicts (None holds no
    leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of value trees of one structure (nested
    dicts), as `jax.tree.map`, called in `tree_leaves`'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if gamma is not None:
        x = x * (1.0 + gamma.to(torch.float32))
    return x.to(dt)


def layernorm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no gain/bias), float32 math."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    centered = x - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    return (centered * torch.rsqrt(var + eps)).to(dt)


def norm_eps(cfg) -> float:
    """The RMSNorm epsilon of ``cfg``: its ``norm_eps`` where the config
    carries one (`configs.moonlight_16b_a3b.MLAConfig`), else 1e-6."""
    return getattr(cfg, "norm_eps", 1e-6)


def norm(cfg, x: torch.Tensor, gamma: torch.Tensor | None) -> torch.Tensor:
    if cfg.norm == "layernorm_nonparam":
        return layernorm_nonparam(x)
    return rmsnorm(x, gamma, norm_eps(cfg))


def init_norm(cfg, ini: Init, d: int) -> Annotated | None:
    if cfg.norm == "layernorm_nonparam":
        return None
    return ini.param((d,), ("embed",), kind="zeros")   # gamma stored as (1+g)


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half-rotation)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S]) integer."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)             # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(cfg, ini: Init) -> dict:
    p = {"table": ini.param((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                            scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = ini.param((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return p


def embed(cfg, p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Table lookup; Gemma scales it by sqrt(d_model), as the reference
    does (in the activation dtype)."""
    x = p["table"].to(dtype)[tokens]
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def unembed(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in the activation dtype."""
    if cfg.tie_embeddings:
        logits = x @ p["table"].to(x.dtype).T
    else:
        logits = x @ p["head"].to(x.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = (torch.tanh(logits.to(torch.float32) / c) * c).to(x.dtype)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE: float32 logsumexp minus the gold logit, on
    logits of any dtype; ``mask`` (0/1, labels' shape) averages over the
    kept positions."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (torch.nn.functional.silu(g) * u) @ w_down.to(x.dtype)


def init_mlp(cfg, ini: Init, d: int | None = None,
             ff: int | None = None) -> dict:
    d = d or cfg.d_model
    ff = ff or cfg.d_ff
    return {
        "gate": ini.param((d, ff), ("embed", "ff")),
        "up": ini.param((d, ff), ("embed", "ff")),
        "down": ini.param((ff, d), ("ff", "embed")),
    }
