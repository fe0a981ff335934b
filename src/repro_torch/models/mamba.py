"""Mamba2 (SSD) block: the chunked scan for training and prefill, the O(1)
state recurrence for decode.

Port of `repro.models.mamba`.  Shapes: d_in = expand * d_model inner
channels, nh = d_in / hd heads (the state is shared across a head's dims,
Mamba2's multi-value form), ns = ssm_state.

`mamba_fwd` projects, convolves and gates around `ssd`, the SSD block
decomposition, in plain torch as the reference's is in plain JAX (no
Pallas kernel):

  * intra-chunk: a lower-triangular "attention" of C against B with decay
    weights exp(cum_l - cum_s), [B, nC, Lc, Lc, nh] float32, contracted
    pairwise (scores times weights, then against the inputs) so that no
    six-index tensor is formed.  The decay is masked to -inf above the
    diagonal before its exp: the same zeros as the reference's
    ``where(tri, exp(decay), 0)``, without the overflowing exp whose
    gradient would be 0 * inf;
  * inter-chunk: the reference's associative scan over chunks is the SSD
    "state passing" form here: the state entering chunk c is
    sum_{c' < c} exp(sum_{c' < j < c} log a_j) chunk_in[c'], one einsum
    against an [nC, nC] lower-triangular decay matrix whose exponents are
    segment sums (a cumulative sum of a masked matrix: every entry sums
    its own terms from zero, no difference of large prefix sums).  The
    chunk inputs and the carry stay float32, as in the reference.

`mamba_decode` updates the caller's `MambaState` in place (its S and conv
tensors, which may be views of a stacked cache) and returns it, as
`attention.decode_attention` does with a KV cache: a functional copy of
every layer's state each step would move the whole SSM state per token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .common import Init


class MambaState(NamedTuple):
    S: torch.Tensor        # [B, nh, hd, ns] float32 state matrices
    conv: torch.Tensor     # [B, KW - 1, conv_dim] causal-conv tail buffer


KW = 4  # depthwise conv width


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


def init_mamba(cfg, ini: Init) -> dict:
    d = cfg.d_model
    d_in, nh, ns, hd = dims(cfg)
    conv_dim = d_in + 2 * ns
    return {
        "wz": ini.param((d, d_in), ("embed", "dinner")),
        "wx": ini.param((d, d_in), ("embed", "dinner")),
        "wB": ini.param((d, ns), ("embed", "state")),
        "wC": ini.param((d, ns), ("embed", "state")),
        "wdt": ini.param((d, nh), ("embed", "ssm_heads")),
        "dt_bias": ini.param((nh,), ("ssm_heads",), kind="zeros"),
        "A_log": ini.param((nh,), ("ssm_heads",), kind="zeros"),
        "Dskip": ini.param((nh,), ("ssm_heads",), kind="ones"),
        "conv_w": ini.param((KW, conv_dim), ("conv", "dinner"), scale=0.5),
        "conv_b": ini.param((conv_dim,), ("dinner",), kind="zeros"),
        "gamma": ini.param((d_in,), ("dinner",), kind="zeros"),
        "wo": ini.param((d_in, d), ("dinner", "embed")),
    }


def _project(cfg, p, u):
    dt_ = u.dtype
    z = u @ p["wz"].to(dt_)
    x = u @ p["wx"].to(dt_)
    Bm = u @ p["wB"].to(dt_)
    Cm = u @ p["wC"].to(dt_)
    dt = u @ p["wdt"].to(dt_)
    return z, x, Bm, Cm, dt


def _gated_out(cfg, p, y, z, B, S, d_in):
    dt_ = z.dtype                 # residual/activation dtype (y may be f32)
    y = y.reshape(B, S, d_in).to(dt_) * F.silu(z)
    yf = y.to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    y = (yf * (1.0 + p["gamma"].to(torch.float32))).to(dt_)
    return y @ p["wo"].to(dt_)


def _state_passing(cum_last, chunk_in):
    """States entering each chunk: cum_last [B, nC, nh] (each chunk's total
    log decay), chunk_in [B, nC, nh, hd, ns] float32 -> [B, nC, nh, hd,
    ns], the first chunk's zero."""
    nC = cum_last.shape[1]
    dev = cum_last.device
    L = cum_last.transpose(1, 2)                          # [B, nh, nC]
    below = torch.tril(torch.ones((nC, nC), dtype=torch.bool, device=dev),
                       diagonal=-1)
    # seg[j, c'] = sum_{c' < i <= j} L_i, each entry summed from zero
    X = torch.where(below, L[..., :, None], 0.0)          # X[j, c'] = L_j
    seg = torch.cumsum(X, dim=-2)
    # entering chunk c: sum_{c' < j < c} L_j = seg[c - 1, c'], for c' < c
    seg = torch.cat([torch.zeros_like(seg[..., :1, :]), seg[..., :-1, :]],
                    dim=-2)
    W = torch.exp(torch.where(below, seg, float("-inf")))  # [B, nh, c, c']
    return torch.einsum("bhcd,bdhpn->bchpn", W, chunk_in)


def ssd(xbar, Bm, Cm, loga, Lc: int) -> torch.Tensor:
    """The SSD core of `mamba_fwd` over chunks of ``Lc`` tokens: xbar [B,
    S, nh, hd] (the dt-scaled input), Bm and Cm [B, S, ns], loga [B, S,
    nh] float32 (log decays), S a multiple of Lc -> y [B, S, nh, hd]
    float32 (before the skip term): y_t = sum_{s <= t} (C_t . B_s)
    exp(sum_{s < j <= t} loga_j) xbar_s."""
    B, S, nh, hd = xbar.shape
    nC = S // Lc
    f32 = torch.float32

    def chunk(t):
        return t.reshape(B, nC, Lc, *t.shape[2:])
    xc, Bc, Cc, lc = map(chunk, (xbar, Bm, Cm, loga))
    cum = torch.cumsum(lc, dim=2)                             # [B,nC,Lc,nh]

    # intra-chunk: y_l = sum_{s <= l} (C_l . B_s) exp(cum_l - cum_s) xbar_s,
    # heads ahead of (l, s) so that the last product is one batched matmul
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)          # [B,nC,Lc,Lc]
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                device=xbar.device))
    cum_h = cum.transpose(2, 3)                               # [B,nC,nh,Lc]
    decay = cum_h[..., :, None] - cum_h[..., None, :]         # [B,nC,nh,l,s]
    wgt = torch.exp(torch.where(tri, decay, float("-inf")))
    del decay
    sw = scores.to(f32)[:, :, None] * wgt                     # [B,nC,nh,l,s]
    del wgt
    y_intra = (sw @ xc.to(f32).transpose(2, 3)).transpose(2, 3)
    del sw                                                    # [B,nC,l,nh,hd]

    # inter-chunk state carry
    seg = torch.exp(cum[:, :, -1:, :] - cum)                  # [B,nC,Lc,nh]
    chunk_in = torch.einsum("bcshp,bcsn->bchpn",
                            xc.to(f32) * seg[..., None],
                            Bc.to(f32))                       # [B,nC,nh,hd,ns]
    S_in = _state_passing(cum[:, :, -1, :], chunk_in)
    y_inter = torch.einsum("bcln,bchpn->bclhp", Cc,
                           S_in.to(Cc.dtype)) * torch.exp(cum).to(
                               Cc.dtype)[..., None]
    return (y_intra + y_inter).reshape(B, S, nh, hd)


def mamba_fwd(cfg, p: dict, u: torch.Tensor) -> torch.Tensor:
    """Train/prefill: u [B, S, d] -> [B, S, d] via the chunked SSD scan."""
    B, S0, d = u.shape
    pad = (-S0) % min(cfg.ssm_chunk, S0)
    if pad:
        u = torch.cat([u, torch.zeros((B, pad, d), dtype=u.dtype,
                                      device=u.device)], dim=1)
    S = u.shape[1]
    d_in, nh, ns, hd = dims(cfg)
    Lc = min(cfg.ssm_chunk, S)
    f32 = torch.float32

    z, x, Bm, Cm, dt = _project(cfg, p, u)

    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xp = torch.cat([torch.zeros((B, KW - 1, xbc.shape[-1]), dtype=xbc.dtype,
                                device=xbc.device), xbc], dim=1)
    w = p["conv_w"].to(xbc.dtype)
    conv = sum(xp[:, i:i + S] * w[i] for i in range(KW))
    xbc = F.silu(conv + p["conv_b"].to(xbc.dtype))
    x, Bm, Cm = torch.split(xbc, [d_in, ns, ns], dim=-1)

    x = x.reshape(B, S, nh, hd)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))        # [B, S, nh]
    A = -torch.exp(p["A_log"].to(f32))                        # [nh] (< 0)
    loga = dt * A                                             # log decay
    xbar = x * dt.to(x.dtype)[..., None]                      # dt-scaled input

    y = ssd(xbar, Bm, Cm, loga, Lc)
    y = y + x * p["Dskip"].to(x.dtype)[:, None]
    out = _gated_out(cfg, p, y, z[:, :S], B, S, d_in)
    return out[:, :S0] if pad else out


def init_mamba_state(cfg, batch: int, dtype, device=None,
                     abstract: bool = False) -> MambaState:
    """Zero state on ``device``: CUDA unless the caller asks for the CPU,
    the meta device when ``abstract``."""
    dev = resolve_device(device, abstract)
    d_in, nh, ns, hd = dims(cfg)
    conv_dim = d_in + 2 * ns
    return MambaState(
        torch.zeros((batch, nh, hd, ns), dtype=torch.float32, device=dev),
        torch.zeros((batch, KW - 1, conv_dim), dtype=dtype, device=dev))


def mamba_state_axes(state: MambaState) -> MambaState:
    """Logical axes of a (possibly stacked) MambaState: a MambaState of
    axis tuples."""
    pre = ("layers",) * (state.S.dim() - 4)
    return MambaState(S=pre + ("cache_batch", "ssm_heads", None, None),
                      conv=pre + ("cache_batch", None, "act_dinner"))


def mamba_decode(cfg, p: dict, u: torch.Tensor, state: MambaState):
    """u: [B, 1, d] -> (out [B, 1, d], state): the O(1) state update,
    written into ``state``'s tensors in place."""
    B = u.shape[0]
    d_in, nh, ns, hd = dims(cfg)
    f32 = torch.float32
    z, x, Bm, Cm, dt = _project(cfg, p, u)

    xbc = torch.cat([x, Bm, Cm], dim=-1)                      # [B,1,conv_dim]
    hist = torch.cat([state.conv.to(xbc.dtype), xbc], dim=1)  # [B,KW,conv_dim]
    w = p["conv_w"].to(xbc.dtype)
    conv = torch.einsum("bkc,kc->bc", hist, w)[:, None, :]
    xbc_c = F.silu(conv + p["conv_b"].to(xbc.dtype))
    x, Bm, Cm = torch.split(xbc_c, [d_in, ns, ns], dim=-1)

    x = x.reshape(B, nh, hd)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))[:, 0]  # [B, nh]
    A = -torch.exp(p["A_log"].to(f32))
    a = torch.exp(dt * A)                                     # [B, nh]
    xbar = x.to(f32) * dt[..., None]

    S1 = state.S.mul_(a[:, :, None, None]).add_(torch.einsum(
        "bhp,bn->bhpn", xbar, Bm[:, 0].to(f32)))
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), S1)
    y = y.to(u.dtype) + x * p["Dskip"].to(x.dtype)[:, None]
    out = _gated_out(cfg, p, y[:, None], z, B, 1, d_in)
    state.conv.copy_(hist[:, 1:])
    return out, state
