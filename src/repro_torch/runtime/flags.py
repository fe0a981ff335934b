"""Process-local model flags.

Port of `repro.runtime.flags`' two attention flags: each is a
`contextvars.ContextVar` with the reference's default, set for the span
of a context manager and read by its reader.

  * `attention_impl` / `attn_impl`: "naive" (materialized scores) or
    "chunked" (`models.attention.sdpa_chunked`, and `sdpa_banded` for
    causal sliding-window layers).
  * `context_parallel` / `ctx_par`: the reference shards the query
    sequence over the model axis; on one device it keeps the whole query
    sequence as one chunk.

Their reader is the dry-run stack (ROADMAP A13), which sets them from
`RunConfig.attn_impl`/`ctx_par`; the port's `attention` does not read
them yet (on the CPU it is `sdpa`, on the card the flash kernel).  The
reference's `seq_parallel_tp` and `unrolled_scans` change nothing on one
device in eager torch and are left out.

`layer_scan(f, init, xs)` is the reference's `lax.scan` over a stack as
a Python loop over the leading axis of ``xs``.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_ATTN = contextvars.ContextVar("repro_attn_impl", default="naive")
_CTX_PAR = contextvars.ContextVar("repro_ctx_par", default=False)


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
