"""On the card: the two kernel instances Moonlight-16B-A3B's prefill adds,
each against its plain version.  Skips without a CUDA device; imports no
JAX.

  * The sm90 flash kernel's (192, 128) instance (q/k head dim 192, v 128,
    bfloat16) against float32 attention on the same bfloat16 inputs
    (`scaled_dot_product_attention` in float32, as a yardstick): within
    bfloat16 rounding of the output, 1e-5 + 2^-8 |ref| (the bound of the
    other sm90 instances' tests), causal and not, ragged lengths, GQA, and
    the model's layout (q and k [B, S, H, 192] and v a [B, S, H, 128]
    column slice, as views).  float32 at (192, 128) is refused.
  * The gate's sigmoid mode bit for bit against `ref.bp_topk_route_ref`
    on all three of the kernel's paths, float32 and bfloat16, with and
    without the bias, twice back to back.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mla_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.bp_topk import kernel as gate_kernel
from repro_torch.kernels.bp_topk.ref import bp_topk_route_ref
from repro_torch.kernels.flash_attention import kernel as fkernel


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _yardstick(q, k, v, causal):
    """float32 attention of the bf16 inputs ([B, H, S, D] each)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    k, v = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    with sdpa_kernel(SDPBackend.MATH):
        return torch.nn.functional.scaled_dot_product_attention(
            q.float(), k, v, is_causal=causal)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,causal", [
    (1, 16, 16, 1000, True), (2, 4, 2, 333, True), (1, 2, 2, 130, False),
    (1, 16, 16, 8192, True)])
def test_flash_192_128_within_bf16_rounding(B, H, KH, S, causal):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(S + H)
    q = torch.randn((B, H, S, 192), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((B, KH, S, 192), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((B, KH, S, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    before = fkernel.flash_attention.launches_sm90
    out = fkernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fkernel.flash_attention.launches_sm90 == before + 1
    assert out.shape == (B, H, S, 128) and out.dtype == torch.bfloat16
    want = _yardstick(q, k, v, causal)
    err = (out.float() - want).abs() - (1e-5 + 2 ** -8 * want.abs())
    assert float(err.max()) <= 0, float(err.max())


@pytest.mark.gpu
def test_flash_192_128_in_the_models_layout():
    """q and k as [B, S, H, 192] projections' views, v a 128-column slice
    of a [B, S, H, 256] tensor (the latent expansion's k_nope | v), through
    the wrapper as `models.attention._kernel_core` hands them over."""
    _card()
    B, S, H = 2, 700, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((B, S, H, 192), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, H, 192), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kvb = torch.randn((B, S, H, 256), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    v = kvb[..., 128:]
    out = fkernel.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))
    dense = fkernel.flash_attention(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert out.transpose(1, 2).is_contiguous()
    want = _yardstick(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), True)
    err = (out.float() - want).abs() - (1e-5 + 2 ** -8 * want.abs())
    assert float(err.max()) <= 0
    with pytest.raises(ValueError, match="q/k 192, v 128"):
        fkernel.flash_attention(q.float().transpose(1, 2),
                                k.float().transpose(1, 2),
                                v.float().transpose(1, 2))


@pytest.mark.gpu
def test_sigmoid_gate_matches_plain_bitwise():
    """Four-lanes-per-row path (T >= 16,384 at E = 64: Moonlight's
    prefill), warp-per-row path (a decode step's shapes) and shared-memory
    path (E > 256); random and tie-heavy logits; each launched twice (the
    workspace left zero)."""
    _card()
    rng = np.random.default_rng(31)
    shapes = [(65536, 64, 6), (16384, 64, 6), (8, 64, 6), (37, 64, 6),
              (33, 300, 7), (4096, 32, 8)]
    for T, E, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for ties, bp in ((False, True), (True, True), (False, False)):
                if ties:
                    s = rng.integers(-2, 3, size=(T, E)).astype(np.float32)
                else:
                    s = rng.standard_normal((T, E)).astype(np.float32)
                logits = torch.from_numpy(s).to(dtype).cuda()
                H = torch.from_numpy(rng.integers(0, 6, size=E).astype(
                    np.float32) * 0.5).cuda()
                steps = torch.tensor(3, dtype=torch.int32, device="cuda")
                cap = T * k / E
                want = bp_topk_route_ref(logits, H, steps, cap, k, bp,
                                         "sigmoid", 2.446)
                for _ in range(2):
                    got = gate_kernel.bp_topk_route(
                        logits, H, steps, cap, k, bp, score="sigmoid",
                        scale=2.446)
                    torch.cuda.synchronize()
                    case = (T, E, k, dtype, ties, bp)
                    for a, b in zip(got, want):
                        assert a.dtype == b.dtype and a.shape == b.shape
                        assert torch.equal(a, b), case
