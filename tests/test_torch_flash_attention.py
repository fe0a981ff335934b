"""Parity of the port's flash attention with the reference.

On the CPU the port's wrapper runs its plain PyTorch version
(`flash_attention_ref`); it must agree with the JAX package's Pallas
kernel (interpret mode) and its `attention_ref` within the bounds of
`tests/test_kernels.py`: 1e-5 in float32, 2e-2 in bfloat16.  Torch
emulations of the two CUDA kernels pin their algebra without a GPU:
  * the CUDA-core kernel's fold (64-query x 64-key tiles, the blocks it
    skips, the mask applied only on edge blocks, one running max, sum and
    accumulator per row), held to the plain version at the same bounds;
  * the sm90 kernel's (128-query blocks as two 64-row warpgroups, 128- or
    64-key tiles, S of bf16 operands in float32 with the scale and log2(e)
    applied to S, exp2, P split into bf16 p_hi + p_lo, O += p_hi V +
    p_lo V), held in bf16 to the plain version, to the Pallas kernel, and
    within bf16 rounding (1e-5 + 2^-8 |ref|) of float32 math; the split
    itself is pinned on adversarial p.
The `gpu`-marked tests hold both CUDA kernels to the plain version on the
card (each case through the kernel its dtype and head dim select), a
reduced float32 prefill on the card (flash attention and bp_topk_route in every
layer) to the CPU's, within 1e-4, and each layer's attention in a reduced
bfloat16 prefill on the card (the sm90 kernel) within bf16 rounding of
float32 math on that layer's own q, k and v; they skip without a card and
need no JAX.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_ref, key_mask)

# (B, H, KH, S, T, D, causal, window, dtype): tests/test_kernels.py:21-30,
# then ragged lengths (not multiples of the kernel's 64-row tile).
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, "float32"),
    (1, 4, 4, 256, 256, 32, True, 64, "float32"),
    (2, 2, 1, 128, 256, 64, False, None, "float32"),
    (1, 8, 2, 128, 128, 128, True, None, "bfloat16"),
    (1, 2, 2, 64, 64, 16, True, 16, "float32"),
    (1, 1, 1, 512, 512, 64, True, 128, "float32"),
]
RAGGED_CASES = [
    (1, 4, 2, 100, 100, 64, True, None, "float32"),
    (2, 2, 1, 77, 130, 32, False, None, "float32"),
    (1, 4, 2, 200, 200, 16, True, 50, "bfloat16"),
    (1, 2, 1, 12, 12, 16, True, None, "float32"),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BQ = BK = 64        # the kernel's tile (BQ, BK in csrc/flash_attention.cu)
#: bf16 outputs against float32 math: |out - ref| <= 1e-5 + 2^-8 |ref|
#: (rounding to bf16 moves a value by at most 2^-8 of itself).
BF16_ROUNDING = (1e-5, 2.0 ** -8)
#: The cases the sm90 kernel takes: head dim 64 or 128, run in bfloat16.
SM90_CASES = [c[:8] + ("bfloat16",) for c in FLASH_CASES + RAGGED_CASES
              if c[5] in (64, 128)]


def kv_blocks(q0, S, T, *, causal, window):
    """The 64-key blocks the kernel visits for the query block starting at
    ``q0`` (``lo``, ``hi`` in the source): those holding a key that some
    row q0..q0+63 below S may see."""
    q_last = min(q0 + BQ, S) - 1
    lo_key = max(q0 - window + 1, 0) if window is not None else 0
    hi_key = min(T - 1, q_last) if causal else T - 1
    if hi_key < lo_key:
        return range(0)
    return range(lo_key // BK, hi_key // BK + 1)


def inputs(case, seed=0):
    """numpy float32 q [B,H,S,D], k/v [B,KH,T,D] from a seed."""
    B, H, KH, S, T, D = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, D), (B, KH, T, D), (B, KH, T, D)))


def as_torch(arrays, dtype):
    return tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in arrays)


@pytest.fixture(scope="module")
def J():
    """The JAX reference: the Pallas kernel's op (interpret mode) and its
    oracle."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention.ops import (attention_ref,
                                                   flash_attention_op as op)
    return types.SimpleNamespace(jnp=jax.numpy, op=op, ref=attention_ref)


@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES)
def test_plain_matches_pallas_kernel_and_ref(J, case):
    B, H, KH, S, T, D, causal, window, dtype = case
    arrays = inputs(case)
    out = tkernel.flash_attention(*as_torch(arrays, dtype), causal=causal,
                                  window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, H, S, D)
    jargs = [J.jnp.asarray(a).astype(getattr(J.jnp, dtype)) for a in arrays]
    # the Pallas kernel needs S, T divisible by its blocks: ragged cases
    # run it as one block
    blocks = (dict(block_q=64, block_k=64) if S % 64 == 0 and T % 64 == 0
              else dict(block_q=S, block_k=T))
    wants = (J.op(*jargs, causal=causal, window=window, **blocks),
             J.ref(*jargs, causal=causal, window=window))
    for want in wants:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def emulate_kernel(q, k, v, *, causal, window):
    """The CUDA kernel's algebra in torch: per (batch, head, 64-query
    block), stage q * scale and the visited 64-key blocks as float32, mask
    only edge blocks, fold each block into a running max / sum / acc."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S, BQ):
                rows = torch.arange(q0, q0 + BQ)
                qs = torch.zeros((BQ, D))
                n = min(BQ, S - q0)
                qs[:n] = q[b, h, q0:q0 + n].float() * scale
                m = torch.full((BQ,), NEG_INF)
                l = torch.zeros(BQ)
                acc = torch.zeros((BQ, D))
                q_last = min(q0 + BQ, S) - 1
                for kb in kv_blocks(q0, S, T, causal=causal,
                                    window=window):
                    k0 = kb * BK
                    ks = torch.zeros((BK, D))
                    vs = torch.zeros((BK, D))
                    nk = min(BK, T - k0)
                    ks[:nk] = k[b, h // G, k0:k0 + nk].float()
                    vs[:nk] = v[b, h // G, k0:k0 + nk].float()
                    s = qs @ ks.T
                    edge = (k0 + BK > T or (causal and k0 + BK - 1 > q0) or
                            (window is not None and k0 <= q_last - window))
                    ok = torch.ones((BQ, BK), dtype=torch.bool)
                    if edge:
                        keys = torch.arange(k0, k0 + BK)[None, :]
                        ok = keys < T
                        if causal:
                            ok = ok & (rows[:, None] >= keys)
                        if window is not None:
                            ok = ok & (keys > rows[:, None] - window)
                        s = torch.where(ok, s, NEG_INF)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vs
                    m = m_new
                den = torch.clamp(l, min=1e-30)[:, None]
                out[b, h, q0:q0 + n] = (acc / den)[:n]
    return out.to(q.dtype)


@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES)
def test_kernel_fold_emulation_matches_plain(case):
    *_, causal, window, dtype = case
    q, k, v = as_torch(inputs(case, seed=1), dtype)
    got = emulate_kernel(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


SM90_BQ, SM90_ROWS = 128, 64   # csrc/flash_attention_sm90.cu: a CTA's
#: query rows and a warpgroup's


def sm90_bk(D):
    """The sm90 kernel's kv tile (Cfg<D>::BK)."""
    return 128 if D == 64 else 64


def sm90_tiles(r0, S, T, *, bk, causal, window, rows=SM90_ROWS):
    """kv_tiles in the sm90 source: the tiles holding a key that some row
    r0 .. r0 + rows - 1 below S may see."""
    r_last = min(r0 + rows, S) - 1
    lo_key = max(r0 - window + 1, 0) if window is not None else 0
    hi_key = min(T - 1, r_last) if causal else T - 1
    if r_last < r0 or hi_key < lo_key:
        return range(0)
    return range(lo_key // bk, hi_key // bk + 1)


def split_p(p):
    """p_hi = bf16(p), p_lo = bf16(p - p_hi), both as float32."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def emulate_sm90(q, k, v, *, causal, window):
    """The sm90 kernel's arithmetic in torch, per (batch, head, 64-row
    warpgroup of a 128-query block): S = q k^T of the bf16 operands in
    float32, times scale * log2(e) (one float32 product, as in the C
    entry); masked keys of edge tiles set to NEG_INF; m' = max(m, max S),
    alpha = exp2(m - m'), p = exp2(S - m') (0 on masked keys, and below
    2^-126, which ex2.approx.ftz flushes); l = l alpha + sum p;
    O = O alpha + p_hi V + p_lo V; out = O / max(l, 1e-30) in bf16."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G, bk = H // KH, sm90_bk(D)
    c = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b in range(B):
        for h in range(H):
            kf, vf = k[b, h // G].float(), v[b, h // G].float()
            for r0 in range(0, S, SM90_ROWS):      # both warpgroups of
                rows = torch.arange(r0, r0 + SM90_ROWS)   # each CTA
                n = min(SM90_ROWS, S - r0)
                qs = torch.zeros((SM90_ROWS, D))
                qs[:n] = q[b, h, r0:r0 + n].float()
                m = torch.full((SM90_ROWS,), NEG_INF)
                l = torch.zeros(SM90_ROWS)
                o = torch.zeros((SM90_ROWS, D))
                for kb in sm90_tiles(r0, S, T, bk=bk, causal=causal,
                                     window=window):
                    k0 = kb * bk
                    ks = torch.zeros((bk, D))
                    vs = torch.zeros((bk, D))
                    nk = min(bk, T - k0)
                    ks[:nk], vs[:nk] = kf[k0:k0 + nk], vf[k0:k0 + nk]
                    s = (qs @ ks.T) * c
                    edge = (k0 + bk > T or (causal and k0 + bk - 1 > r0) or
                            (window is not None and
                             k0 <= r0 + SM90_ROWS - 1 - window))
                    ok = torch.ones((SM90_ROWS, bk), dtype=torch.bool)
                    if edge:
                        keys = torch.arange(k0, k0 + bk)[None, :]
                        ok = keys < T
                        if causal:
                            ok = ok & (rows[:, None] >= keys)
                        if window is not None:
                            ok = ok & (keys > rows[:, None] - window)
                        s = torch.where(ok, s, NEG_INF)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(ok, torch.exp2(s - m_new[:, None]), 0.0)
                    p = torch.where(p < 2.0 ** -126, 0.0, p)
                    l = l * alpha + p.sum(dim=1)
                    hi, lo = split_p(p)
                    o = o * alpha[:, None] + hi @ vs + lo @ vs
                    m = m_new
                out[b, h, r0:r0 + n] = (o / torch.clamp(l, min=1e-30)[:, None]
                                        )[:n]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("case", SM90_CASES)
def test_sm90_emulation_matches_plain_within_bf16_rounding(case):
    *_, causal, window, dtype = case
    q, k, v = as_torch(inputs(case, seed=1), dtype)
    got = emulate_sm90(q, k, v, causal=causal, window=window).float()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
    atol, rtol = BF16_ROUNDING
    np.testing.assert_allclose(got.numpy(), want32.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", SM90_CASES)
def test_sm90_emulation_matches_pallas_kernel(J, case):
    B, H, KH, S, T, D, causal, window, dtype = case
    arrays = inputs(case, seed=1)
    got = emulate_sm90(*as_torch(arrays, dtype), causal=causal,
                       window=window).float().numpy()
    jargs = [J.jnp.asarray(a).astype(J.jnp.bfloat16) for a in arrays]
    blocks = (dict(block_q=64, block_k=64) if S % 64 == 0 and T % 64 == 0
              else dict(block_q=S, block_k=T))
    want = J.op(*jargs, causal=causal, window=window, **blocks)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_p_split_leaves_at_most_2_to_the_minus_16():
    """|p - (p_hi + p_lo)| <= 2^-16 |p|, or 2^-134 (half bf16's subnormal
    spacing) where p < 2^-103 lets p - p_hi fall below bf16's normal
    range; p_hi and p_lo are bf16 values."""
    rng = np.random.default_rng(7)
    tiny = np.float32(2.0 ** -126)
    ps = np.concatenate([
        rng.random(100_000, dtype=np.float32),                  # (0, 1)
        np.exp2(-rng.random(100_000) * 126).astype(np.float32),  # all scales
        np.float32(2.0) ** -np.arange(0, 127, dtype=np.float32),  # powers
        np.array([1 - 2.0 ** -24, 1 - 2.0 ** -9, 1 + 2.0 ** -8,
                  1 + 3 * 2.0 ** -9, 0.5 + 2.0 ** -10], np.float32),
        tiny * (1 + np.arange(1, 4097, dtype=np.float32) * 2.0 ** -23),
        tiny * (1 + rng.random(10_000, dtype=np.float32)),      # subnormal-
        np.float32(2.0 ** -103) * (1 + rng.random(10_000, dtype=np.float32)),
    ]).astype(np.float32)                                       # adjacent
    p = torch.from_numpy(ps)
    hi, lo = split_p(p)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    err = (p.double() - hi.double() - lo.double()).abs()
    bound = torch.clamp(p.double().abs() * 2.0 ** -16, min=2.0 ** -134)
    assert bool((err <= bound).all()), float((err / bound).max())
    normal = p >= 2.0 ** -103
    assert bool((err[normal] <= p.double()[normal] * 2.0 ** -16).all())


@pytest.mark.parametrize("S,T", [(100, 100), (512, 512), (77, 130),
                                 (256, 64), (1, 1), (300, 1000)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 33),
                                           (True, 1), (True, 0)])
@pytest.mark.parametrize("D", [64, 128])
def test_sm90_skipped_tiles_hold_no_valid_key(S, T, causal, window, D):
    """Every key a row may see lies in a tile its warpgroup computes, and
    the CTA's tile range (its two warpgroups' rows) covers both."""
    bk = sm90_bk(D)
    mask = key_mask(S, T, causal=causal, window=window).numpy()
    for r0 in range(0, S, SM90_ROWS):
        seen = np.zeros(T, bool)
        for kb in sm90_tiles(r0, S, T, bk=bk, causal=causal, window=window):
            seen[kb * bk:(kb + 1) * bk] = True
        assert not (mask[r0:r0 + SM90_ROWS] & ~seen[None, :]).any()
    for q0 in range(0, S, SM90_BQ):
        cta = set(sm90_tiles(q0, S, T, bk=bk, causal=causal, window=window,
                             rows=SM90_BQ))
        for r0 in (q0, q0 + SM90_ROWS):
            assert set(sm90_tiles(r0, S, T, bk=bk, causal=causal,
                                  window=window)) <= cta


def test_dispatch_by_dtype_and_head_dim():
    assert tkernel.uses_sm90(torch.bfloat16, 64)
    assert tkernel.uses_sm90(torch.bfloat16, 128)
    for dtype, D in ((torch.bfloat16, 16), (torch.bfloat16, 32),
                     (torch.float32, 64), (torch.float32, 128)):
        assert not tkernel.uses_sm90(dtype, D)
        assert D in tkernel.HEAD_DIMS[dtype]


def test_tma_ready_strides():
    x = torch.zeros((2, 300, 4, 64), dtype=torch.bfloat16)   # [B, S, H, D]
    assert tkernel.tma_ready(x.transpose(1, 2))
    assert tkernel.tma_ready(torch.zeros((1, 4, 9, 128), dtype=torch.bfloat16))
    padded = torch.zeros((1, 4, 9, 68), dtype=torch.bfloat16)[..., :64]
    assert not tkernel.tma_ready(padded)                # 136-byte rows
    flat = torch.zeros(4 * 9 * 64 + 1, dtype=torch.bfloat16)
    assert not tkernel.tma_ready(flat[1:].view(1, 4, 9, 64))   # 2 B offset
    # a dim of length 1 may have any stride
    one = torch.zeros((4, 1, 9, 64), dtype=torch.bfloat16).transpose(0, 1)
    assert tkernel.tma_ready(one[:, :1]) and tkernel._map_strides(
        one[:, :1])[1] == 8


@pytest.mark.parametrize("S,T", [(100, 100), (512, 512), (77, 130),
                                 (256, 64), (1, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 33),
                                           (True, 1), (False, 0)])
def test_skipped_blocks_hold_no_valid_key(S, T, causal, window):
    """Every key a row may see lies in a visited block, and every block
    the kernel skips is masked for every row of its query block."""
    mask = key_mask(S, T, causal=causal, window=window).numpy()
    for q0 in range(0, S, BQ):
        seen = np.zeros(T, bool)
        for kb in kv_blocks(q0, S, T, causal=causal, window=window):
            seen[kb * BK:(kb + 1) * BK] = True
        assert not (mask[q0:q0 + BQ] & ~seen[None, :]).any()
        visited = list(kv_blocks(q0, S, T, causal=causal, window=window))
        if visited and window != 0:   # neither end of the range is empty
            for kb in (visited[0], visited[-1]):
                assert mask[q0:q0 + BQ, kb * BK:(kb + 1) * BK].any()


def test_rows_without_keys_are_zero_and_strided_inputs_agree():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 70, 4, 16)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 70, 2, 16)).astype(
        np.float32))
    # window 0 leaves no key for any row
    out = tkernel.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                  kv.transpose(1, 2), window=0)
    assert torch.equal(out, torch.zeros_like(out))
    # nor does T = 0, in either dtype and at every head dim (numpy's empty
    # arrays have all-zero strides)
    for D, dtype in ((16, "float32"), (64, "bfloat16"), (128, "bfloat16")):
        q0, k0, v0 = as_torch(inputs((1, 4, 2, 5, 0, D)), dtype)
        out = tkernel.flash_attention(q0, k0, v0, causal=False)
        assert out.dtype == q0.dtype
        assert torch.equal(out, torch.zeros_like(q0))
    strided = flash_attention_op(q.transpose(1, 2), kv.transpose(1, 2),
                                 kv.transpose(1, 2), window=9, block_q=7)
    dense = flash_attention_ref(q.transpose(1, 2).contiguous(),
                                kv.transpose(1, 2).contiguous(),
                                kv.transpose(1, 2).contiguous(), window=9)
    assert torch.equal(strided, dense)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 4, 8, 16))
    kv = torch.zeros((1, 2, 8, 16))
    with pytest.raises(TypeError):
        tkernel.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        tkernel.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        tkernel.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                                torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError):
        tkernel.flash_attention(q, kv, torch.zeros((1, 2, 9, 16)))
    with pytest.raises(ValueError):
        tkernel.flash_attention(q.transpose(2, 3).contiguous().transpose(
            2, 3), kv, kv)
    with pytest.raises(ValueError):
        tkernel.flash_attention(q, kv, kv, window=-1)
    before = (tkernel.flash_attention.launches,
              tkernel.flash_attention.launches_sm90)
    tkernel.flash_attention(q, kv, kv)
    tkernel.flash_attention(*(t.bfloat16() for t in (
        torch.zeros((1, 4, 8, 64)), torch.zeros((1, 2, 8, 64)),
        torch.zeros((1, 2, 8, 64)))))
    assert (tkernel.flash_attention.launches,
            tkernel.flash_attention.launches_sm90) == before  # CPU: none


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in FLASH_CASES + RAGGED_CASES + SM90_CASES + [
            (1, 16, 8, 1000, 1000, 64, True, None, "bfloat16"),
            (2, 4, 2, 77, 130, 128, False, None, "bfloat16"),
            (1, 4, 2, 700, 700, 128, True, 0, "bfloat16"),
            (1, 2, 1, 64, 64, 32, True, None, "bfloat16")] + [
            # no key at all: zeros and no launch, whichever kernel
            (1, 4, 2, 100, 0, D, causal, None, dtype)
            for D, dtype in ((64, "bfloat16"), (128, "bfloat16"),
                             (32, "bfloat16"), (64, "float32"))
            for causal in (True, False)]:
        *_, T, D, causal, window, dtype = case
        q, k, v = (t.cuda() for t in as_torch(inputs(case, seed=2), dtype))
        before = (tkernel.flash_attention.launches,
                  tkernel.flash_attention.launches_sm90)
        out = tkernel.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        sm90 = tkernel.uses_sm90(q.dtype, D)
        ran = T > 0
        assert (tkernel.flash_attention.launches,
                tkernel.flash_attention.launches_sm90) == (
                    before[0] + (ran and not sm90), before[1] + (ran and sm90)
                    ), str(case)
        if not ran:
            assert torch.equal(out, torch.zeros_like(q)), str(case)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(case))
        if dtype == "bfloat16":     # within bf16 rounding of float32 math
            want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       want32.cpu().numpy(), rtol=2.0 ** -8,
                                       atol=1e-5, err_msg=str(case))
    # the model's [B, S, H, D] layout through strides, no copy
    qs = q.transpose(1, 2).contiguous()
    out = tkernel.flash_attention(qs.transpose(1, 2), k, v)
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(out, tkernel.flash_attention(q, k, v),
                               rtol=0, atol=0)
    # bf16 rows of 136 bytes: no tensor map takes them, so the sm90 kernel
    # gets a copy (the same kernel, the same result)
    q, k, v = (t.cuda() for t in as_torch(inputs(
        (1, 4, 2, 100, 100, 64), seed=3), "bfloat16"))
    padded = torch.zeros((1, 4, 100, 68), dtype=torch.bfloat16,
                         device="cuda")
    padded[..., :64] = q
    assert not tkernel.tma_ready(padded[..., :64])
    before = tkernel.flash_attention.launches_sm90
    out = tkernel.flash_attention(padded[..., :64], k, v)
    assert tkernel.flash_attention.launches_sm90 == before + 1
    torch.testing.assert_close(out, tkernel.flash_attention(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_prefill_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.bp_topk import kernel as topk_kernel
    from repro_torch.models import get_model, split_tree
    cfg = reduced(get_config("granite-moe-1b-a400m"), n_experts=32, top_k=8,
                  head_dim=64)
    api = get_model(cfg)
    params, _ = split_tree(api.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)))
    H = torch.zeros((cfg.n_layers, cfg.n_experts))
    flash0 = tkernel.flash_attention.launches
    topk0 = topk_kernel.bp_topk.launches
    route0 = topk_kernel.bp_topk_route.launches
    got, gH, _ = api.logits(
        {k: to_device(v, "cuda") for k, v in params.items()},
        {"tokens": toks.cuda()}, activ_dtype=torch.float32,
        router_H=H.cuda())
    torch.cuda.synchronize()
    assert tkernel.flash_attention.launches == flash0 + cfg.n_layers
    assert topk_kernel.bp_topk_route.launches == route0 + cfg.n_layers
    assert topk_kernel.bp_topk.launches == topk0
    want, wH, _ = api.logits(params, {"tokens": toks},
                             activ_dtype=torch.float32, router_H=H)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(gH.cpu(), wH)


@pytest.mark.gpu
def test_bf16_prefill_attention_within_rounding(monkeypatch):
    """Teacher-forced: each layer's attention output in a bfloat16 prefill
    on the card, as the sm90 kernel gave it inside the forward, within bf16
    rounding of float32 math on that layer's own q, k and v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention, get_model, split_tree
    cfg = reduced(get_config("granite-moe-1b-a400m"), n_experts=32, top_k=8,
                  head_dim=64)
    api = get_model(cfg)
    params, _ = split_tree(api.init(torch.Generator().manual_seed(1)))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 300)))
    calls = []

    def recording(q, k, v, **kw):
        out = flash_attention_op(q, k, v, **kw)
        calls.append((q, k, v, out, kw))
        return out

    monkeypatch.setattr(attention, "flash_attention_op", recording)
    before = (tkernel.flash_attention.launches,
              tkernel.flash_attention.launches_sm90)
    logits, _, _ = api.logits(
        to_device(params, "cuda"), {"tokens": toks.cuda()},
        activ_dtype=torch.bfloat16,
        router_H=torch.zeros((cfg.n_layers, cfg.n_experts), device="cuda"))
    torch.cuda.synchronize()
    assert len(calls) == cfg.n_layers
    assert (tkernel.flash_attention.launches,
            tkernel.flash_attention.launches_sm90) == (
                before[0], before[1] + cfg.n_layers)
    assert bool(torch.isfinite(logits).all())
    atol, rtol = BF16_ROUNDING
    for i, (q, k, v, out, kw) in enumerate(calls):
        assert out.dtype == torch.bfloat16
        want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.cpu().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"layer {i}")


def to_device(tree, dev):
    """A copy of a dict tree of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)
