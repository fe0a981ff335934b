"""Parity of the port's flash attention with the reference.

On the CPU the port's wrapper runs its plain PyTorch version
(`flash_attention_ref`); it must agree with the JAX package's Pallas
kernel (interpret mode) and its `attention_ref` within the bounds of
`tests/test_kernels.py`: 1e-5 in float32, 2e-2 in bfloat16.  A torch
emulation of the CUDA kernel's fold (64-query x 64-key tiles, the blocks
it skips, the mask applied only on edge blocks, one running max, sum and
accumulator per row) is held to the plain version at the same bounds: it
pins the kernel's algebra without a GPU.  The `gpu`-marked tests hold the
CUDA kernel to the plain version on the card, and a reduced prefill on the
card (flash attention and bp_topk in every layer) to the CPU's, within
1e-4; they skip without a card and need no JAX.
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
    before = tkernel.flash_attention.launches
    tkernel.flash_attention(q, kv, kv)
    assert tkernel.flash_attention.launches == before  # CPU: no launch


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in FLASH_CASES + RAGGED_CASES + [
            (1, 16, 8, 1000, 1000, 64, True, None, "bfloat16")]:
        *_, causal, window, dtype = case
        q, k, v = (t.cuda() for t in as_torch(inputs(case, seed=2), dtype))
        before = tkernel.flash_attention.launches
        out = tkernel.flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert tkernel.flash_attention.launches == before + 1
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
    got, gH, _ = api.logits(
        {k: to_device(v, "cuda") for k, v in params.items()},
        {"tokens": toks.cuda()}, activ_dtype=torch.float32,
        router_H=H.cuda())
    torch.cuda.synchronize()
    assert tkernel.flash_attention.launches == flash0 + cfg.n_layers
    assert topk_kernel.bp_topk.launches == topk0 + cfg.n_layers
    want, wH, _ = api.logits(params, {"tokens": toks},
                             activ_dtype=torch.float32, router_H=H)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(gH.cpu(), wH)


def to_device(tree, dev):
    """A copy of a dict tree of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)
