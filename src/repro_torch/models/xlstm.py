"""xLSTM blocks: mLSTM (matrix memory; parallel quadratic form for training
and prefill, O(1) recurrent decode) and sLSTM (scalar memory with
exponential gating and a block-diagonal recurrence, sequential over time).

Port of `repro.models.xlstm`.  Pattern: one sLSTM per `slstm_every` blocks,
the rest mLSTM, stacked {"mlstm": [n_groups, k - 1, ...], "slstm":
[n_groups, ...]} and split into views as `transformer.unstack` splits.
d_ff = 0 in the config: the blocks carry their own projections (mLSTM up
by 2, sLSTM a post-MLP of 4/3 with the tanh gelu, `jax.nn.gelu`'s
default).  The mLSTM's head dim is 2 d_model / n_heads, not
`cfg.head_dim`.

Neither block reaches a Pallas kernel in the reference, and both are plain
torch here.  The reference's `mlstm_fwd` constrains its query-sequence
axis under context parallelism; that only shards, and on one device it
changes nothing, so it is left out.  The sLSTM's `lax.scan` over time is
a Python loop over tokens in eager torch; the cell's input projections,
which do not depend on the recurrence, are one product over all tokens
before the loop.  Under the dry-run's `runtime.flags.single_slstm_step`
(meta tensors only) the loop runs one step (`slstm_scan`).

`mlstm_decode` and `slstm_decode` update the caller's state in place (its
tensors may be views of a stacked cache) and return it;
`lm_decode_step` returns the same `XLSTMCache`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..runtime import flags
from . import transformer as tfm
from .common import (Init, cross_entropy, embed, init_embedding, init_norm,
                     norm, unembed)


def _dims(cfg):
    d = cfg.d_model
    d_in = 2 * d                       # mLSTM projection factor 2
    nh = cfg.n_heads
    hd = d_in // nh
    return d, d_in, nh, hd


def _logsigmoid(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor      # [B, nh, hd, hd] matrix memory
    n: torch.Tensor      # [B, nh, hd] normalizer
    m: torch.Tensor      # [B, nh] stabilizer


def init_mlstm(cfg, ini: Init) -> dict:
    d, d_in, nh, hd = _dims(cfg)
    return {
        "ln": init_norm(cfg, ini, d),
        "wup": ini.param((d, 2 * d_in), ("embed", "dinner")),
        "wq": ini.param((d_in, nh, hd), ("dinner", "ssm_heads", None)),
        "wk": ini.param((d_in, nh, hd), ("dinner", "ssm_heads", None)),
        "wv": ini.param((d_in, nh, hd), ("dinner", "ssm_heads", None)),
        "wi": ini.param((d_in, nh), ("dinner", "ssm_heads"), scale=0.02),
        "bi": ini.param((nh,), ("ssm_heads",), kind="zeros"),
        "wf": ini.param((d_in, nh), ("dinner", "ssm_heads"), scale=0.02),
        "bf": ini.param((nh,), ("ssm_heads",), kind="ones"),
        "gamma": ini.param((d_in,), ("dinner",), kind="zeros"),
        "wdown": ini.param((d_in, d), ("dinner", "embed")),
    }


def _mlstm_project(p, xin):
    dt = xin.dtype
    f32 = torch.float32
    q = torch.einsum("bsd,dhk->bshk", xin, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xin, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xin, p["wv"].to(dt))
    i = (xin @ p["wi"].to(dt)).to(f32) + p["bi"].to(f32)
    f = (xin @ p["wf"].to(dt)).to(f32) + p["bf"].to(f32)
    return q, k, v, i, f


def _headnorm(y, gamma, B, S, d_in):
    """Per-head RMS norm, then the channel scale (xLSTM's group norm)."""
    yf = y.to(torch.float32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    yf = yf.reshape(B, S, d_in)
    return yf * (1.0 + gamma.to(torch.float32))


def _up(cfg, p, x):
    h = norm(cfg, x, p.get("ln"))
    up = h @ p["wup"].to(h.dtype)
    return up.chunk(2, dim=-1)                            # xin, z


def mlstm_fwd(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Parallel (train/prefill) form: x [B, S, d] -> [B, S, d], with the
    [B, S, S, nh] float32 decay matrix of the reference."""
    B, S, d = x.shape
    _, d_in, nh, hd = _dims(cfg)
    xin, z = _up(cfg, p, x)
    q, k, v, i, f = _mlstm_project(p, xin)

    Fc = torch.cumsum(_logsigmoid(f), dim=1)              # [B, S, nh]
    D = Fc[:, :, None, :] - Fc[:, None, :, :] + i[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    D = torch.where(tri, D, float("-inf"))                # [B, t, s, nh]
    m = D.amax(dim=2)                                     # [B, t, nh]
    w = torch.exp(D - m[:, :, None, :])
    del D
    scores = torch.einsum("bthk,bshk->btsh", q, k) / math.sqrt(hd)
    scores = scores.to(torch.float32) * w
    del w
    denom = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))
    y = torch.einsum("btsh,bshk->bthk", scores.to(v.dtype), v)
    y = y / denom[..., None].to(v.dtype)
    y = _headnorm(y, p["gamma"], B, S, d_in).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["wdown"].to(x.dtype)


def init_mlstm_state(cfg, batch: int, dtype=None, device=None,
                     abstract: bool = False) -> MLSTMState:
    """Zero float32 state on ``device``: CUDA unless the caller asks for
    the CPU, the meta device when ``abstract`` (``dtype`` is the
    reference's argument; the state is float32 whatever the
    activations)."""
    dev = resolve_device(device, abstract)
    _, d_in, nh, hd = _dims(cfg)
    return MLSTMState(*(torch.zeros(s, dtype=torch.float32, device=dev)
                        for s in ((batch, nh, hd, hd), (batch, nh, hd),
                                  (batch, nh))))


def mlstm_decode(cfg, p: dict, x: torch.Tensor, st: MLSTMState):
    """x [B, 1, d] -> (out [B, 1, d], st), ``st`` updated in place."""
    B = x.shape[0]
    _, d_in, nh, hd = _dims(cfg)
    f32 = torch.float32
    xin, z = _up(cfg, p, x)
    q, k, v, i, f = _mlstm_project(p, xin)
    q, k, v = (t[:, 0].to(f32) for t in (q, k, v))       # [B, nh, hd]
    i, f = i[:, 0], f[:, 0]                               # [B, nh]

    logsig_f = _logsigmoid(f)
    m_new = torch.maximum(logsig_f + st.m, i)
    a = torch.exp(logsig_f + st.m - m_new)[:, :, None]
    b = torch.exp(i - m_new)[:, :, None]
    C = st.C.mul_(a[..., None]).add_(
        b[..., None] * k[..., :, None] * v[..., None, :])
    n = st.n.mul_(a).add_(b * k)
    st.m.copy_(m_new)
    qs = q / math.sqrt(hd)
    num = torch.einsum("bhk,bhkv->bhv", qs, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qs, n).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype)                # [B, nh, hd]
    y = _headnorm(y.reshape(B, 1, nh, hd), p["gamma"], B, 1,
                  d_in).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["wdown"].to(x.dtype), st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor      # [B, d]
    n: torch.Tensor      # [B, d]
    hprev: torch.Tensor  # [B, d]
    m: torch.Tensor      # [B, d]


GATES = ("i", "f", "z", "o")


def init_slstm(cfg, ini: Init) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    ffs = int(math.ceil(4 * d / 3 / 128) * 128)
    p = {"ln": init_norm(cfg, ini, d),
         "ln_mlp": init_norm(cfg, ini, d),
         "up": ini.param((d, ffs), ("embed", "ff")),
         "down": ini.param((ffs, d), ("ff", "embed"))}
    for g in GATES:
        p[f"w{g}"] = ini.param((d, d), ("embed", None), scale=0.02)
        p[f"r{g}"] = ini.param((nh, hd, hd), ("ssm_heads", None, None),
                               scale=0.02)
        p[f"b{g}"] = ini.param((d,), (None,),
                               kind="ones" if g == "f" else "zeros")
    return p


def _slstm_inputs(p, xs):
    """The gates' input products x W for every token: xs [..., d] float32
    -> [4, ..., d] (i, f, z, o)."""
    return torch.stack([xs @ p[f"w{g}"].to(torch.float32) for g in GATES])


def _slstm_cell(cfg, R, bias, gx, st: SLSTMState):
    """One timestep: R [4, nh, hd, hd] (the recurrent weights), bias
    [4, 1, d], gx [4, B, d] (the input products), all float32 -> (h [B,
    d], new state).  A gate is x W + h R + b, summed in the reference's
    order."""
    d = cfg.d_model
    nh = cfg.n_heads
    B = gx.shape[1]
    hp = st.hprev.reshape(B, nh, d // nh)
    rec = torch.einsum("bhk,ghkl->gbhl", hp, R).reshape(4, B, d)
    i, f, z, o = (gx + rec + bias).unbind(0)
    logsig_f = _logsigmoid(f)
    m_new = torch.maximum(logsig_f + st.m, i)
    fi = torch.exp(logsig_f + st.m - m_new)
    ii = torch.exp(i - m_new)
    c = fi * st.c + ii * torch.tanh(z)
    n = fi * st.n + ii
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return h, SLSTMState(c=c, n=n, hprev=h, m=m_new)


def _recurrent(p):
    """The recurrent weights [4, nh, hd, hd] and biases [4, 1, d] of the
    gates i, f, z, o, float32."""
    f32 = torch.float32
    return (torch.stack([p[f"r{g}"].to(f32) for g in GATES]),
            torch.stack([p[f"b{g}"].to(f32) for g in GATES])[:, None])


def _post_mlp(cfg, p, x):
    h = norm(cfg, x, p.get("ln_mlp"))
    h = F.gelu(h @ p["up"].to(x.dtype), approximate="tanh")
    return x + h @ p["down"].to(x.dtype)


def slstm_scan(cfg, R, bias, gx, st: SLSTMState) -> torch.Tensor:
    """The reference's `lax.scan` of `_slstm_cell` over time, as a loop
    over tokens: gx [4, S, B, d] -> hs [B, S, d] float32.

    Under `runtime.flags.single_slstm_step` (the dry-run's trace) the
    loop runs its first step only and expands that step's output over
    the S tokens: the same shapes and one step's operations.  The flag
    refuses tensors that are not on the meta device."""
    if flags.slstm_single_step():
        bad = [t.device for t in (R, bias, gx, *st) if t.device.type != "meta"]
        if bad:
            raise RuntimeError(f"single_slstm_step traces meta tensors only; "
                               f"got a tensor on {bad[0]}")
        h, _ = _slstm_cell(cfg, R, bias, gx[:, 0], st)
        return h[:, None].expand(h.shape[0], gx.shape[1], h.shape[1])
    hs = []
    # one unbind (its backward one stack), not S slices each of whose
    # backward would write a zero tensor of gx's size
    for g in gx.unbind(1):
        h, st = _slstm_cell(cfg, R, bias, g, st)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_fwd(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential over time: x [B, S, d] -> [B, S, d]."""
    B = x.shape[0]
    h0 = norm(cfg, x, p.get("ln")).to(torch.float32)
    gx = _slstm_inputs(p, h0.transpose(0, 1))             # [4, S, B, d]
    y = slstm_scan(cfg, *_recurrent(p), gx,
                   init_slstm_state(cfg, B, device=x.device)).to(x.dtype)
    return _post_mlp(cfg, p, x + y)


def init_slstm_state(cfg, batch: int, dtype=None, device=None,
                     abstract: bool = False) -> SLSTMState:
    """Zero float32 state on ``device``, resolved as `init_mlstm_state`."""
    dev = resolve_device(device, abstract)
    return SLSTMState(*(torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                                    device=dev) for _ in range(4)))


def slstm_decode(cfg, p, x, st: SLSTMState):
    """x [B, 1, d] -> (out [B, 1, d], st), ``st`` updated in place."""
    h0 = norm(cfg, x, p.get("ln")).to(torch.float32)[:, 0]
    h, new = _slstm_cell(cfg, *_recurrent(p), _slstm_inputs(p, h0), st)
    for t, v in zip(st, new):
        t.copy_(v)
    return _post_mlp(cfg, p, x + h.to(x.dtype)[:, None]), st


# ---------------------------------------------------------------------------
# Stack + LM wrappers
# ---------------------------------------------------------------------------

def _groups(cfg):
    """(n_groups, mLSTM blocks a group): each group is k - 1 mLSTM blocks
    and one sLSTM."""
    k = cfg.slstm_every
    n_groups = cfg.n_layers // k
    if n_groups * k != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups "
                         f"of {k}")
    return n_groups, k - 1


def init_lm(cfg, gen: torch.Generator | None = None, dtype=torch.float32,
            abstract: bool = False) -> dict:
    """Annotated parameter tree, drawn from ``gen`` on its device (meta
    tensors and no generator when ``abstract``)."""
    ini = Init(gen=gen, dtype=dtype, abstract=abstract)
    n_groups, km = _groups(cfg)
    return {
        "embed": init_embedding(cfg, ini),
        "stack": {"mlstm": init_mlstm(cfg, ini.stacked(n_groups, km)),
                  "slstm": init_slstm(cfg, ini.stacked(n_groups))},
        "ln_f": init_norm(cfg, ini, cfg.d_model),
    }


def stack_fwd(cfg, p, x, *, remat="full"):
    """Every group: its mLSTM blocks, then its sLSTM, each block
    rematerialized unless ``remat`` is "none" (the reference's
    `jax.checkpoint`)."""
    mode = "none" if remat == "none" else "full"
    m_fwd = tfm._remat(mlstm_fwd, mode)
    s_fwd = tfm._remat(slstm_fwd, mode)
    n_groups, km = _groups(cfg)
    for lp_m, lp_s in zip(tfm.unstack(p["mlstm"], n_groups),
                          tfm.unstack(p["slstm"], n_groups)):
        for lp in tfm.unstack(lp_m, km):
            x = m_fwd(cfg, lp, x)
        x = s_fwd(cfg, lp_s, x)
    return x


def lm_loss(cfg, params, batch, *, activ_dtype=torch.bfloat16, remat="full",
            router_H=None):
    """batch {tokens [B, S+1]} -> (CE of tokens[:, 1:] given tokens[:, :-1],
    (router_H, {"ce"}))."""
    tokens = batch["tokens"]
    x = embed(cfg, params["embed"], tokens[:, :-1], activ_dtype)
    x = stack_fwd(cfg, params["stack"], x, remat=remat)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)
    ce = cross_entropy(logits, tokens[:, 1:])
    return ce, (router_H, {"ce": ce})


def lm_logits(cfg, params, tokens, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, prefix_embeds=None,
              last_only=False):
    """tokens [B, S] -> (logits [B, S, V] (or [B, 1, V] with
    ``last_only``), router_H, 0)."""
    x = embed(cfg, params["embed"], tokens, activ_dtype)
    x = stack_fwd(cfg, params["stack"], x, remat=remat)
    x = norm(cfg, x, params.get("ln_f"))
    if last_only:
        x = x[:, -1:]
    return (unembed(cfg, params["embed"], x), router_H,
            torch.zeros((), dtype=torch.float32, device=x.device))


class XLSTMCache(NamedTuple):
    mlstm: MLSTMState      # stacked [n_groups, km]
    slstm: SLSTMState      # stacked [n_groups]


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device=None,
                       abstract: bool = False):
    """Zero mLSTM states [n_groups, km] and sLSTM states [n_groups] on
    ``device``: CUDA unless the caller asks for the CPU, the meta device
    when ``abstract`` (``max_len`` is the reference's argument; a
    recurrent state has no length)."""
    n_groups, km = _groups(cfg)
    dev = resolve_device(device, abstract)
    mlstm = init_mlstm_state(cfg, batch, dtype, device=dev)
    slstm = init_slstm_state(cfg, batch, dtype, device=dev)
    return XLSTMCache(mlstm=tfm.stack_state((n_groups, km), mlstm),
                      slstm=tfm.stack_state((n_groups,), slstm))


def cache_axes(tree: XLSTMCache):
    """Logical axes of a (stacked) cache, as the reference's."""
    m, s = tree.mlstm, tree.slstm
    pre = ("layers",) * (m.C.dim() - 4)
    m_ax = MLSTMState(C=pre + ("cache_batch", "ssm_heads", None, None),
                      n=pre + ("cache_batch", "ssm_heads", None),
                      m=pre + ("cache_batch", "ssm_heads"))
    a = ("layers",) * (s.c.dim() - 2) + ("cache_batch", "act_embed")
    return XLSTMCache(mlstm=m_ax, slstm=SLSTMState(c=a, n=a, hprev=a, m=a))


def lm_decode_step(cfg, params, caches: XLSTMCache, tokens, *,
                   activ_dtype=torch.bfloat16, router_H=None):
    """tokens: [B] int -> (logits [B, V], caches), the caches updated in
    place."""
    n_groups, km = _groups(cfg)
    x = embed(cfg, params["embed"], tokens[:, None], activ_dtype)
    stack = params["stack"]
    for lp_m, lp_s, st_m, st_s in zip(
            tfm.unstack(stack["mlstm"], n_groups),
            tfm.unstack(stack["slstm"], n_groups),
            tfm.unstack(caches.mlstm, n_groups),
            tfm.unstack(caches.slstm, n_groups)):
        for lp, st in zip(tfm.unstack(lp_m, km), tfm.unstack(st_m, km)):
            x, _ = mlstm_decode(cfg, lp, x, st)
        x, _ = slstm_decode(cfg, lp_s, x, st_s)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)[:, 0, :]
    return logits, caches
