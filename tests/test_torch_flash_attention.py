"""Parity of the port's flash attention with the reference.

On the CPU the port's wrapper runs its plain PyTorch version
(`flash_attention_ref`); it must agree with the JAX package's Pallas
kernel (interpret mode) and its `attention_ref` within the bounds of
`tests/test_kernels.py`: 1e-5 in float32, 2e-2 in bfloat16.  Torch
emulations of the two CUDA kernels pin their algebra without a GPU:
  * the CUDA-core kernel's fold (CTAs of 128 (head, query) rows covering
    up to 8 heads of a kv head's group, 16-row warps, 32-key tiles, the
    tiles a CTA stages and a warp skips, q pre-scaled by scale * log2(e)
    in one float32 product, exp2, the mask applied only on edge tiles, one
    running max, sum and accumulator per row), held to the plain version at
    the same bounds; its grid covers each (batch, head, query) row once;
  * the sm90 kernel's (128-query blocks as two 64-row warpgroups, 128- or
    64-key tiles, S of bf16 operands in float32 with the scale and log2(e)
    applied to S, exp2, P split into bf16 p_hi + p_lo, O += p_hi V +
    p_lo V), held in bf16 to the plain version, to the Pallas kernel, and
    within bf16 rounding (1e-5 + 2^-8 |ref|) of float32 math; the split
    itself is pinned on adversarial p.
Head dim 80 (zamba2's shared attention) is held the same way: on the
CPU its dispatch (the plain version here; the sm90 kernel in bfloat16 and
the CUDA-core kernel in float32 on the card, an uninstantiated head dim
raising), the plain version against the Pallas kernel, the CUDA-core fold
at D = 80, and the sm90 kernel's route, its D = 128 tile over zero-filled
columns 80-127.
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
#: csrc/flash_attention.cu: a CTA's (head, query) rows, its warps' rows, the
#: keys of a K/V tile, the rows of a lane (rg + 4 i).
ROWS, WROWS, BK, RT = 128, 16, 32, 4
NW = ROWS // WROWS
#: bf16 outputs against float32 math: |out - ref| <= 1e-5 + 2^-8 |ref|
#: (rounding to bf16 moves a value by at most 2^-8 of itself).
BF16_ROUNDING = (1e-5, 2.0 ** -8)
#: The cases the sm90 kernel takes: head dim 64 or 128, run in bfloat16.
SM90_CASES = [c[:8] + ("bfloat16",) for c in FLASH_CASES + RAGGED_CASES
              if c[5] in (64, 128)]


def heads_per_cta(G):
    """heads_per_cta in the source: the largest power of two dividing G,
    at most 8 (GC); a CTA covers GC heads x ROWS / GC queries."""
    gc = 1
    while gc < 8 and G % (2 * gc) == 0:
        gc *= 2
    return gc


def tiles(first, last, T, *, causal, window):
    """tile_range in the source: the BK-key tiles holding a key that some
    query first..last may see."""
    lo_key = max(first - window + 1, 0) if window is not None else 0
    hi_key = min(T - 1, last) if causal else T - 1
    if last < first or hi_key < lo_key:
        return range(0)
    return range(lo_key // BK, hi_key // BK + 1)


def ctas(B, H, KH, S):
    """The kernel's grid (head groups, batch rows, query blocks), CTA by
    CTA in launch order (x fastest): (b, h0, q0, BQ), its first query head
    h0 (GC heads h0 .. h0 + GC - 1) and first query q0 (BQ = ROWS / GC
    queries); the query blocks that see the most keys go first."""
    GC = heads_per_cta(H // KH)
    BQ = ROWS // GC
    nq = -(-S // BQ)
    for z in range(nq):                         # blockIdx.z
        for b in range(B):                      # blockIdx.y
            for x in range(H // GC):            # blockIdx.x
                yield b, x * GC, (nq - 1 - z) * BQ, BQ


def warp_rows(h0, q0, BQ, w):
    """Warp w's head and first query: CTA rows 16 w .. 16 w + 15, row r =
    (head h0 + r // BQ, query q0 + r % BQ)."""
    r0 = w * WROWS
    return h0 + r0 // BQ, q0 + r0 % BQ


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


def ex2(x):
    """ex2.approx.ftz: 2^x, results below 2^-126 flushed to 0."""
    y = torch.exp2(x)
    return torch.where(y < 2.0 ** -126, 0.0, y)


def emulate_kernel(q, k, v, *, causal, window):
    """The CUDA-core kernel's algebra in torch, CTA by CTA and warp by warp
    (`ctas`, `warp_rows`): q times c = scale * log2(e) (one float32
    product); each warp folds the BK-key tiles its rows can see (a subset
    of its CTA's) into a running max, sum and accumulator per row, the
    mask applied only on edge tiles, alpha = exp2(m - m'), p = exp2(s -
    m'), 0 on masked keys; out = acc / max(l, 1e-30)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    c = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b, h0, q0, BQ in ctas(B, H, KH, S):
        cta = tiles(q0, min(q0 + BQ, S) - 1, T, causal=causal, window=window)
        kf, vf = k[b, h0 // G].float(), v[b, h0 // G].float()
        for w in range(NW):
            h, qw0 = warp_rows(h0, q0, BQ, w)
            assert h // G == h0 // G            # one kv head per CTA
            qw_last = min(qw0 + WROWS, S) - 1
            n = qw_last - qw0 + 1
            if n <= 0:
                continue
            mine = tiles(qw0, qw_last, T, causal=causal, window=window)
            assert set(mine) <= set(cta)
            rows = torch.arange(qw0, qw0 + WROWS)
            qs = torch.zeros((WROWS, D))
            qs[:n] = q[b, h, qw0:qw0 + n].float() * c
            m = torch.full((WROWS,), NEG_INF)
            l = torch.zeros(WROWS)
            acc = torch.zeros((WROWS, D))
            for kb in mine:
                k0 = kb * BK
                ks, vs = torch.zeros((BK, D)), torch.zeros((BK, D))
                nk = min(BK, T - k0)
                ks[:nk], vs[:nk] = kf[k0:k0 + nk], vf[k0:k0 + nk]
                s = qs @ ks.T
                edge = (k0 + BK > T or (causal and k0 + BK - 1 > qw0) or
                        (window is not None and k0 <= qw_last - window))
                ok = torch.ones((WROWS, BK), dtype=torch.bool)
                if edge:
                    keys = torch.arange(k0, k0 + BK)[None, :]
                    ok = keys < T
                    if causal:
                        ok = ok & (rows[:, None] >= keys)
                    if window is not None:
                        ok = ok & (keys > rows[:, None] - window)
                    s = torch.where(ok, s, NEG_INF)
                m_new = torch.maximum(m, s.max(dim=1).values)
                alpha = ex2(m - m_new)
                p = torch.where(ok, ex2(s - m_new[:, None]), 0.0)
                l = l * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + p @ vs
                m = m_new
            den = torch.clamp(l, min=1e-30)[:, None]
            out[b, h, qw0:qw0 + n] = (acc / den)[:n]
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


def emulate_sm90(q, k, v, *, causal, window, scale=None):
    """The sm90 kernel's arithmetic in torch, per (batch, head, 64-row
    warpgroup of a 128-query block): S = q k^T of the bf16 operands in
    float32, times scale * log2(e) (one float32 product, as in the C
    entry); masked keys of edge tiles set to NEG_INF; m' = max(m, max S),
    alpha = exp2(m - m'), p = exp2(S - m') (0 on masked keys, and below
    2^-126, which ex2.approx.ftz flushes); l = l alpha + sum p;
    O = O alpha + p_hi V + p_lo V; out = O / max(l, 1e-30) in bf16.
    ``scale`` is the caller's (1/sqrt(D) unless given: the C entry takes
    it as an argument)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G, bk = H // KH, sm90_bk(D)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    c = torch.tensor(scale, dtype=torch.float32) * \
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


def test_async_copy_ready_strides():
    """The CUDA-core kernel's rows are read in 16-byte pieces: a tensor
    whose base or a (batch, head, sequence) stride is not a multiple of 16
    bytes is cloned first (on the card)."""
    for dtype, D in ((torch.float32, 64), (torch.float32, 16),
                     (torch.bfloat16, 16), (torch.bfloat16, 32)):
        x = torch.zeros((2, 300, 4, D), dtype=dtype)        # [B, S, H, D]
        assert tkernel.async_copy_ready(x.transpose(1, 2))
        assert tkernel.async_copy_ready(torch.zeros((1, 4, 9, D), dtype=dtype))
        n = 16 // x.element_size()
        padded = torch.zeros((1, 4, 9, D + n // 2), dtype=dtype)[..., :D]
        assert not tkernel.async_copy_ready(padded)       # rows of D + n/2
        assert tkernel.async_copy_ready(
            torch.zeros((1, 4, 9, D + n), dtype=dtype)[..., :D])  # + 16 B
        flat = torch.zeros(4 * 9 * D + n, dtype=dtype)
        assert not tkernel.async_copy_ready(flat[1:1 + 4 * 9 * D].view(
            1, 4, 9, D))                                  # 2 or 4 B offset
        assert tkernel.async_copy_ready(flat[n:n + 4 * 9 * D].view(
            1, 4, 9, D))                                  # 16 B offset
    # a dim of length 1 may have any stride
    one = torch.zeros((4, 1, 9, 16)).transpose(0, 1)
    assert tkernel.async_copy_ready(one[:, :1])
    # an odd sequence stride of a single row does not matter either
    assert tkernel.async_copy_ready(torch.zeros((1, 2, 1, 20))[..., :16])


@pytest.mark.parametrize("S,T", [(100, 100), (512, 512), (77, 130),
                                 (256, 64), (1, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 33),
                                           (True, 1), (False, 0)])
def test_skipped_blocks_hold_no_valid_key(S, T, causal, window):
    """For every head group G in {1, 2, 4, 8}: every key a row may see lies
    in a tile its warp computes, a warp's tiles lie in its CTA's (the tiles
    staged), and the first and last tile of each range hold a key that a
    row of the warp (of the CTA) may see."""
    mask = key_mask(S, T, causal=causal, window=window).numpy()

    def check_ends(visited, r0, r1):
        if visited and window != 0:   # neither end of the range is empty
            for kb in (visited[0], visited[-1]):
                assert mask[r0:r1, kb * BK:(kb + 1) * BK].any()

    for G in (1, 2, 4, 8):
        for _, h0, q0, BQ in ctas(1, G, 1, S):
            cta = list(tiles(q0, min(q0 + BQ, S) - 1, T, causal=causal,
                             window=window))
            check_ends(cta, q0, q0 + BQ)
            for w in range(NW):
                _, qw0 = warp_rows(h0, q0, BQ, w)
                mine = list(tiles(qw0, min(qw0 + WROWS, S) - 1, T,
                                  causal=causal, window=window))
                assert set(mine) <= set(cta)
                seen = np.zeros(T, bool)
                for kb in mine:
                    seen[kb * BK:(kb + 1) * BK] = True
                assert not (mask[qw0:qw0 + WROWS] & ~seen[None, :]).any()
                check_ends(mine, qw0, qw0 + WROWS)


@pytest.mark.parametrize("S", [1, 16, 100, 129, 300])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 6, 7, 16])
def test_grid_covers_each_row_once(G, S):
    """The kernel's grid, its CTAs' rows and its lanes' rows (rg + 4 i of
    warp w) store each (batch, head, query) once, every head of a CTA
    reads the CTA's kv head, and the query blocks start from the last; G =
    6, 7 (qwen2's 14 heads over 2) take 2 and 1 heads a CTA, G = 16 two
    CTAs of 8."""
    B, KH = 2, 2
    H = G * KH
    assert heads_per_cta(G) == {1: 1, 2: 2, 4: 4, 8: 8, 6: 2, 7: 1, 16: 8}[G]
    stored = np.zeros((B, H, S), int)
    starts = [q0 for _, _, q0, _ in ctas(B, H, KH, S)]
    assert starts == sorted(starts, reverse=True)     # longest first
    for b, h0, q0, BQ in ctas(B, H, KH, S):
        assert {(h0 + r // BQ) // G for r in range(ROWS)} == {h0 // G}
        for w in range(NW):
            h, qw0 = warp_rows(h0, q0, BQ, w)
            for rg in range(4):           # lanes 8 rg .. 8 rg + 7
                for i in range(RT):
                    r = w * WROWS + rg + 4 * i
                    assert h0 + r // BQ == h and q0 + r % BQ == qw0 + rg + 4 * i
                    if qw0 + rg + 4 * i < S:
                        stored[b, h, qw0 + rg + 4 * i] += 1
    assert (stored == 1).all()
    # the 8 lanes of a row store its dims once: lane kg, (8 c + kg) VW + e,
    # VW = 4 where 4 divides D / 8, else 2 (D = 16 and 80)
    for D in (16, 32, 64, 80, 128):
        DL = D // 8
        VW = 4 if DL % 4 == 0 else 2
        assert DL % VW == 0
        dims = sorted((8 * c + kg) * VW + e for kg in range(8)
                      for c in range(DL // VW) for e in range(VW))
        assert dims == list(range(D))


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


#: Head dim 80 (zamba2's shared attention: 32 heads over 32), both dtypes:
#: a ragged causal length, T != S without a mask, a window with G = 4.
D80_CASES = [(1, 4, 4, 100, 100, 80, True, None, dtype)
             for dtype in ("float32", "bfloat16")] + [
    (2, 2, 2, 77, 130, 80, False, None, "float32"),
    (1, 8, 2, 200, 200, 80, True, 50, "bfloat16")]


def test_head_dim_80_dispatch():
    """D = 80 runs the sm90 kernel in bfloat16 and the CUDA-core kernel in
    float32 on the card; on the CPU it is the plain version, no launch;
    a head dim neither kernel instantiates raises for a CUDA call."""
    assert tkernel.kernel_for(torch.bfloat16, 80) == "sm90"
    assert tkernel.kernel_for(torch.float32, 80) == "cuda-core"
    assert tkernel.kernel_for(torch.bfloat16, 32) == "cuda-core"
    for dtype, D in ((torch.float32, 96), (torch.bfloat16, 96),
                     (torch.bfloat16, 48), (torch.float32, 8)):
        with pytest.raises(ValueError, match=f"head dim {D}"):
            tkernel.kernel_for(dtype, D)
    before = (tkernel.flash_attention.launches,
              tkernel.flash_attention.launches_sm90)
    for case in D80_CASES:
        *_, causal, window, dtype = case
        q, k, v = as_torch(inputs(case, seed=5), dtype)
        out = tkernel.flash_attention(q, k, v, causal=causal, window=window)
        assert torch.equal(out, flash_attention_ref(q, k, v, causal=causal,
                                                    window=window))
    # a CPU call of an uninstantiated head dim is the plain version too
    q96 = torch.zeros((1, 2, 5, 96))
    assert tkernel.flash_attention(q96, q96, q96).shape == q96.shape
    assert (tkernel.flash_attention.launches,
            tkernel.flash_attention.launches_sm90) == before


@pytest.mark.parametrize("case", D80_CASES)
def test_head_dim_80_plain_matches_pallas_kernel_and_ref(J, case):
    test_plain_matches_pallas_kernel_and_ref(J, case)


@pytest.mark.parametrize("case", D80_CASES)
def test_head_dim_80_fold_emulation_matches_plain(case):
    """The CUDA-core kernel's fold at D = 80 (its float32 instantiation;
    the algebra is the same in either dtype)."""
    test_kernel_fold_emulation_matches_plain(case)


@pytest.mark.parametrize("case", D80_CASES)
def test_sm90_head_dim_80_runs_the_128_column_tile(case):
    """D = 80 on the sm90 kernel: the D = 128 tile over inputs whose
    columns 80-127 TMA fills with zeros, at the caller's scale 1/sqrt(80):
    columns 80-127 of the tile's output are exactly 0, and the first 80
    hold the plain version within 2e-2 and float32 math within bf16
    rounding."""
    B, H, KH, S, T, D, causal, window, _ = case
    q, k, v = as_torch(inputs(case, seed=6), "bfloat16")

    def pad(t):
        return torch.cat([t, torch.zeros(t.shape[:-1] + (128 - D,),
                                         dtype=t.dtype)], dim=-1)
    tile = emulate_sm90(pad(q), pad(k), pad(v), causal=causal,
                        window=window, scale=1.0 / math.sqrt(D))
    assert torch.equal(tile[..., D:], torch.zeros_like(tile[..., D:]))
    got = tile[..., :D].float()
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
    atol, rtol = BF16_ROUNDING
    np.testing.assert_allclose(got.numpy(), want32.numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
def test_head_dim_80_on_the_card():
    """Both kernels at D = 80 against the plain version (1e-5 float32,
    2e-2 bfloat16, and bf16 within rounding of float32 math), each call
    moving its kernel's counter, twice bit-identical; the model's [B, S,
    H, D] layout passes through strides; a head dim neither kernel
    instantiates raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in D80_CASES + [(1, 32, 32, 1000, 1000, 80, True, None, dt)
                             for dt in ("float32", "bfloat16")] + [
            (8, 32, 32, 512, 512, 80, True, None, "float32")]:
        *_, causal, window, dtype = case
        q, k, v = (t.cuda() for t in as_torch(inputs(case, seed=7), dtype))
        before = (tkernel.flash_attention.launches,
                  tkernel.flash_attention.launches_sm90)
        out = tkernel.flash_attention(q, k, v, causal=causal, window=window)
        again = tkernel.flash_attention(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        sm90 = dtype == "bfloat16"
        assert (tkernel.flash_attention.launches,
                tkernel.flash_attention.launches_sm90) == (
                    before[0] + 2 * (not sm90), before[1] + 2 * sm90)
        assert torch.equal(out, again), str(case)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=str(case))
        if sm90:
            want32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
            np.testing.assert_allclose(out.float().cpu().numpy(),
                                       want32.cpu().numpy(), rtol=2.0 ** -8,
                                       atol=1e-5, err_msg=str(case))
        strided = tkernel.flash_attention(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
            causal=causal, window=window)
        assert torch.equal(strided, out), str(case)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((1, 2, 8, 96), dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match="head dim 96"):
            tkernel.flash_attention(x, x, x)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in FLASH_CASES + RAGGED_CASES + SM90_CASES + [
            (1, 16, 8, 1000, 1000, 64, True, None, "bfloat16"),
            (2, 4, 2, 77, 130, 128, False, None, "bfloat16"),
            (1, 4, 2, 700, 700, 128, True, 0, "bfloat16"),
            (1, 2, 1, 64, 64, 32, True, None, "bfloat16"),
            # the CUDA-core kernel: the training shape; head groups of 4
            # and 8 (one CTA a group) and of 7 (a CTA a head); T != S
            # without a causal mask; a window at D = 128
            (8, 16, 8, 512, 512, 64, True, None, "float32"),
            (1, 16, 4, 300, 300, 64, True, None, "float32"),
            (2, 16, 2, 200, 200, 32, True, None, "float32"),
            (1, 14, 2, 150, 150, 64, True, None, "float32"),
            (2, 4, 2, 100, 333, 64, False, None, "float32"),
            (1, 8, 4, 400, 400, 128, True, 77, "float32")] + [
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
    # f32 rows of 260 bytes and a base 4 bytes off: the CUDA-core kernel's
    # 16-byte copies take neither, so it gets a copy (the same result); two
    # calls on the same inputs are bit-identical
    q, k, v = (t.cuda() for t in as_torch(inputs(
        (1, 16, 8, 300, 300, 64), seed=4), "float32"))
    padded = torch.zeros((1, 16, 300, 65), device="cuda")
    padded[..., :64] = q
    flat = torch.zeros(k.numel() + 1, device="cuda")
    flat[1:] = k.reshape(-1)
    qp, kp = padded[..., :64], flat[1:].view(k.shape)
    assert not tkernel.async_copy_ready(qp)
    assert not tkernel.async_copy_ready(kp)
    before = tkernel.flash_attention.launches
    out = tkernel.flash_attention(qp, kp, v)
    assert tkernel.flash_attention.launches == before + 1
    first = tkernel.flash_attention(q, k, v)
    torch.testing.assert_close(out, first, rtol=0, atol=0)
    assert torch.equal(first, tkernel.flash_attention(q, k, v))
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
