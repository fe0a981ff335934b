"""Process-local model flags.

Port of `repro.runtime.flags`: each flag is a `contextvars.ContextVar`
with the reference's default, set for the span of a context manager and
read by its reader.

  * `attention_impl` / `attn_impl`: "naive" (materialized scores) or
    "chunked" (`models.attention.sdpa_chunked`, and `sdpa_banded` for
    causal sliding-window layers).  `models.attention.attention` reads
    it off the card; on CUDA the core is the flash kernel either way.
  * `context_parallel` / `ctx_par`: the reference shards the query
    sequence over the model axis; on one device the chunked core keeps
    the whole query sequence as one chunk.
  * `single_slstm_step` / `slstm_single_step`: the port's own, set by the
    dry-run (`launch.dryrun`) around its trace: `models.xlstm.slstm_scan`
    steps its time loop once and expands that step over the sequence,
    and the dry-run adds the other steps' cost from its own count of
    short traces (`launch.dryrun._slstm_correction`).  It refuses any tensor that is
    not on the meta device, so it never changes a real run.

The reference's `unrolled_scans` and `seq_parallel_tp` are left out: the
port's `layer_scan` is a Python loop, so a trace sees every layer
already, and sequence-parallel TP only shards, which changes nothing on
one device.

`layer_scan(f, init, xs)` is the reference's `lax.scan` over a stack as
a Python loop over the leading axis of ``xs``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_ATTN = contextvars.ContextVar("repro_attn_impl", default="naive")
_CTX_PAR = contextvars.ContextVar("repro_ctx_par", default=False)
_SLSTM_ONE = contextvars.ContextVar("repro_slstm_one_step", default=False)


@contextlib.contextmanager
def _setting(var: contextvars.ContextVar, value):
    tok = var.set(value)
    try:
        yield
    finally:
        var.reset(tok)


def attention_impl(name: str):
    """naive (materialized scores) | chunked (online softmax)."""
    if name not in ("naive", "chunked"):
        raise ValueError(f"attention impl {name!r}: expected naive or "
                         f"chunked")
    return _setting(_ATTN, name)


def attn_impl() -> str:
    return _ATTN.get()


def context_parallel(on: bool = True):
    return _setting(_CTX_PAR, on)


def ctx_par() -> bool:
    return _CTX_PAR.get()


def single_slstm_step(on: bool = True):
    """The dry-run's sLSTM time loop of one step (module docstring)."""
    return _setting(_SLSTM_ONE, on)


def slstm_single_step() -> bool:
    return _SLSTM_ONE.get()


def _leaves(xs) -> list:
    if isinstance(xs, (tuple, list)):
        return [leaf for x in xs for leaf in _leaves(x)]
    if isinstance(xs, dict):
        return [leaf for k in sorted(xs) for leaf in _leaves(xs[k])]
    return [] if xs is None else [xs]


def _index(xs, i: int):
    if isinstance(xs, (tuple, list)):
        return tuple(_index(x, i) for x in xs)
    if isinstance(xs, dict):
        return {k: _index(v, i) for k, v in xs.items()}
    return None if xs is None else xs[i]


def _stack(ys: list):
    first = ys[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack([y[j] for y in ys]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([y[k] for y in ys]) for k in first}
    return None if first is None else torch.stack(ys)


def layer_scan(f, init, xs):
    """``lax.scan(f, init, xs)``: ``carry, y = f(carry, x)`` over the
    leading axis of every tensor in ``xs`` (nested tuples and dicts; each
    ``x`` holds views), returning (carry, the ys stacked)."""
    n = {int(t.shape[0]) for t in _leaves(xs)}
    if len(n) != 1:
        raise ValueError(f"layer_scan: leading axes {sorted(n)} differ")
    carry, ys = init, []
    for i in range(n.pop()):
        carry, y = f(carry, _index(xs, i))
        ys.append(y)
    return carry, _stack(ys)
