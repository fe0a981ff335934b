"""The port's attention forms and flags against the reference, on the CPU.

`sdpa_banded`, `sdpa_chunked`, `attention` (against the reference's under
each impl, with context parallelism on and off), `prefill_cache`,
`encode_kv` and `cross_attention` run on the same inputs (numpy, fixed
seeds) in both packages, float32; tolerances 1e-5 abs / 1e-4 rel (XLA and
torch sum the scores and the online softmax in other orders).  The flags'
context managers nest and reset as the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.runtime import flags as jflags  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.runtime import flags as tflags  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def qkv(seed, B, S, H, KH, D, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KH, D)).astype(np.float32),
            rng.standard_normal((B, T, KH, D)).astype(np.float32))


def arange_pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


def both(fn_t, fn_j, *arrays, **kw):
    out = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return out.numpy(), np.asarray(want)


@pytest.mark.parametrize("S,window", [(37, 8), (64, 16), (128, 32), (16, 16)])
def test_banded_matches_reference_and_sdpa(S, window):
    """tests/test_kernels.py's four banded cases."""
    q, k, v = qkv(7, 2, S, 4, 2, 16)
    pos = arange_pos(2, S)
    out, want = both(tattn.sdpa_banded, jattn.sdpa_banded, q, k, v, pos, pos,
                     window=window)
    np.testing.assert_allclose(out, want, **TOL)
    tp = torch.from_numpy(np.array(pos))
    ref = tattn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                     tattn._mask(tp, tp, causal=True, window=window))
    np.testing.assert_allclose(out, ref.numpy(), **TOL)


CHUNKED = ([(n, w, True) for n in range(1, 6) for w in (8, 16)] +
           [(2, None, True), (3, None, False), (4, 8, False)])


@pytest.mark.parametrize("nblocks,window,causal", CHUNKED)
def test_chunked_matches_reference(nblocks, window, causal):
    """tests/test_kernels.py's hypothesis ranges (S = 16 nblocks + 3,
    window 8 or 16, chunks of 16) as a grid, plus non-causal and
    window-None cases."""
    S = 16 * nblocks + 3
    q, k, v = qkv(nblocks * 31 + (window or 0), 1, S, 2, 2, 8)
    pos = arange_pos(1, S)
    kw = dict(causal=causal, window=window, chunk_q=16, chunk_k=16)
    out, want = both(tattn.sdpa_chunked, jattn.sdpa_chunked, q, k, v, pos,
                     pos, **kw)
    np.testing.assert_allclose(out, want, **TOL)
    tp = torch.from_numpy(np.array(pos))
    ref = tattn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                     tattn._mask(tp, tp, causal=causal, window=window))
    np.testing.assert_allclose(out, ref.numpy(), **TOL)


def test_chunked_with_invalid_keys_and_gqa():
    """Keys at position -1 (empty cache slots) are masked; S != T; G = 3."""
    q, k, v = qkv(3, 2, 21, 6, 2, 8, T=30)
    qpos = np.broadcast_to(np.arange(9, 30, dtype=np.int32)[None], (2, 21))
    kpos = np.broadcast_to(np.arange(30, dtype=np.int32)[None], (2, 30)).copy()
    kpos[:, 25:] = -1
    out, want = both(tattn.sdpa_chunked, jattn.sdpa_chunked, q, k, v, qpos,
                     kpos, causal=True, window=12, chunk_q=8, chunk_k=8)
    np.testing.assert_allclose(out, want, **TOL)


def attn_params(arch, seed=1, **over):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    jp, _ = jcommon.split_tree(jattn.init_attn(jcfg, jcommon.Init(
        key=jax.random.key(seed))))
    if "bq" in jp:         # non-zero biases, so that the bias path counts
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32)) if k.startswith("b") else v) for k, v in jp.items()}
    return tcfg, jcfg, jp, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp), "cpu")


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("window,causal", [(None, True), (8, True),
                                           (None, False)])
def test_attention_matches_reference_under_each_flag(impl, ctx, window,
                                                     causal):
    """The port's CPU attention (sdpa) equals the reference's under each
    of its cores: naive, chunked, banded, one query chunk."""
    tcfg, jcfg, jp, tp = attn_params("qwen2-0.5b")
    S = 37
    x = np.random.default_rng(2).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    pos = arange_pos(2, S)
    out = tattn.attention(tcfg, tp, torch.from_numpy(x),
                          torch.from_numpy(np.array(pos)),
                          window=window, causal=causal)
    with jflags.attention_impl(impl), jflags.context_parallel(ctx):
        want = jattn.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               window=window, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_matches_reference():
    tcfg, jcfg, _, _ = attn_params("qwen2-0.5b")
    _, k, v = qkv(4, 2, 5, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim)
    tc = tattn.init_cache(tcfg, 2, 9, torch.float32, device="cpu")
    got = tattn.prefill_cache(tc, torch.from_numpy(k), torch.from_numpy(v))
    want = jattn.prefill_cache(jattn.init_cache(jcfg, 2, 9, jnp.float32),
                               jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tc.pos) == 0 and int(tc.kpos.max()) == -1   # left as it was


@pytest.mark.parametrize("masked", [False, True])
def test_encode_kv_and_cross_attention_match_reference(masked):
    tcfg, jcfg, jp, tp = attn_params("qwen2-0.5b")
    rng = np.random.default_rng(6)
    mem = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 4, tcfg.d_model)).astype(np.float32)
    tk, tv = tattn.encode_kv(tcfg, tp, torch.from_numpy(mem))
    jk, jv = jattn.encode_kv(jcfg, jp, jnp.asarray(mem))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    m = rng.random((2, 4, 11)) < 0.7 if masked else None
    out = tattn.cross_attention(tcfg, tp, torch.from_numpy(x), (tk, tv),
                                None if m is None else torch.from_numpy(m))
    want = jattn.cross_attention(jcfg, jp, jnp.asarray(x), (jk, jv),
                                 None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_flags_nest_and_reset():
    for mod in (tflags, jflags):
        assert mod.attn_impl() == "naive" and not mod.ctx_par()
        with mod.attention_impl("chunked"):
            with mod.attention_impl("naive"), mod.context_parallel():
                assert mod.attn_impl() == "naive" and mod.ctx_par()
                with mod.context_parallel(False):
                    assert not mod.ctx_par()
                assert mod.ctx_par()
            assert mod.attn_impl() == "chunked" and not mod.ctx_par()
        assert mod.attn_impl() == "naive" and not mod.ctx_par()
        try:
            with mod.attention_impl("chunked"):
                raise KeyError("inside")
        except KeyError:
            pass
        assert mod.attn_impl() == "naive"
    with pytest.raises(ValueError):
        with tflags.attention_impl("flash"):
            pass


def test_layer_scan_loops_and_stacks():
    xs = (torch.arange(6.0).reshape(3, 2), {"a": torch.ones(3)})

    def f(c, x):
        row, d = x
        return c + row.sum() * d["a"], {"y": row * 2, "n": None}
    carry, ys = tflags.layer_scan(f, torch.zeros(()), xs)
    assert float(carry) == 15.0
    assert torch.equal(ys["y"], xs[0] * 2) and ys["n"] is None
    with pytest.raises(ValueError, match="leading axes"):
        tflags.layer_scan(f, 0, (torch.zeros(3, 2), {"a": torch.ones(4)}))
