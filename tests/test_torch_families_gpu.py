"""The dense (local/global), VLM, encoder-decoder, zamba (Mamba2 + shared
attention) and xLSTM families on the card
(`gpu`-marked: skipped without a CUDA device; needs no JAX, so it runs on
the card's machine).

Reduced configs (head dim 16: every attention core runs the CUDA-core
flash kernel, float32 or bfloat16).  gemma3 with window 8 at S=40 on the
card against the same weights on the CPU, logits within 1e-4 (float32
sums in other orders); cross-attention with S != T, not causal, against
the plain version within 1e-5 (2e-2 in bfloat16), and the families'
own head layouts (internvl2's 14 over 2, seamless's encoder and cross
rows) likewise; `cross_attention` refuses a memory mask on the card; the
VLM's and the encoder-decoder's prefills launch the kernel once per
attention core (the VLM's layers; the encoder's, the decoder's self and
its cross layers).  zamba and xLSTM, reduced (zamba at its head dim 80,
so its shared block runs the kernels' D = 80 paths): float32 logits card
against the CPU within 1e-4, decode on the card against its forward
within 2e-3, and the launches of a bf16 prefill (one sm90 launch per
application of the shared block; none for xLSTM, whose blocks are plain
torch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models.attention import cross_attention  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def launches():
    return fkernel.flash_attention.launches + \
        fkernel.flash_attention.launches_sm90


@pytest.mark.gpu
def test_reduced_gemma3_on_the_card_matches_the_cpu():
    card()
    tcfg = tconfigs.reduced(tconfigs.get_config("gemma3-27b"), n_layers=8)
    api = get_model(tcfg)
    params, _ = split_tree(api.init(torch.Generator("cuda").manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 40)))
    before = launches()
    got, _, _ = api.logits(params, {"tokens": toks.cuda()},
                           activ_dtype=torch.float32)
    torch.cuda.synchronize()
    assert launches() - before == tcfg.n_layers
    want, _, _ = api.logits(tree_map(lambda p: p.cpu(), params),
                            {"tokens": toks}, activ_dtype=torch.float32)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(1, 1500), (37, 300), (512, 1500)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_shapes_on_the_card(S, T, dtype):
    card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(S)
    q = torch.randn((2, 16, S, 64), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((2, 16, T, 64), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    out = fkernel.flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,T,causal", [
    (1, 14, 2, 320, 320, True),        # internvl2: G=7 behind its patches
    (1, 16, 16, 600, 600, False),      # seamless's encoder
    (1, 16, 16, 256, 1024, False)])    # seamless's cross rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_head_layouts_on_the_card(B, H, KH, S, T, causal, dtype):
    card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(H + S)
    q = torch.randn((B, H, S, 64), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, KH, T, 64), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    out = fkernel.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cross_attention_refuses_a_mask_on_the_card():
    card()
    tcfg = tconfigs.reduced(tconfigs.get_config("seamless-m4t-large-v2"))
    Dh, H, d = tcfg.head_dim, tcfg.n_heads, tcfg.d_model
    p = {"wq": torch.randn((d, H, Dh), device="cuda"),
         "wo": torch.randn((H, Dh, d), device="cuda")}
    x = torch.randn((1, 3, d), device="cuda")
    kv = tuple(torch.randn((1, 5, tcfg.n_kv_heads, Dh), device="cuda")
               for _ in range(2))
    with pytest.raises(NotImplementedError, match="mask"):
        cross_attention(tcfg, p, x, kv, torch.ones((1, 3, 5),
                                                   dtype=torch.bool,
                                                   device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-large-v2"])
def test_prefill_launch_counts(arch):
    card()
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    api = get_model(tcfg)
    params, _ = split_tree(api.init(torch.Generator("cuda").manual_seed(0),
                                    dtype=torch.bfloat16))
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, tcfg.vocab, (2, 24))).cuda()}
    if tcfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, tcfg.n_patches,
                                             tcfg.d_model), device="cuda")
        want = tcfg.n_layers
    else:
        batch["frames"] = torch.randn((2, 30, tcfg.d_model), device="cuda")
        want = tcfg.enc_layers + 2 * tcfg.dec_layers
    before = launches()
    with torch.inference_mode():
        logits, _, _ = api.logits(params, batch, last_only=True)
    torch.cuda.synchronize()
    assert launches() - before == want
    assert logits.shape == (2, 1, tcfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,attn_calls", [("zamba2-2.7b", 2),
                                             ("xlstm-350m", 0)])
def test_recurrent_families_on_the_card(arch, attn_calls):
    card()
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), head_dim=80)
    api = get_model(tcfg)
    params, _ = split_tree(api.init(torch.Generator("cuda").manual_seed(3)))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab, (2, 150)))
    before = fkernel.flash_attention.launches
    got, _, _ = api.logits(params, {"tokens": toks.cuda()},
                           activ_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fkernel.flash_attention.launches - before == attn_calls
    want, _, _ = api.logits(tree_map(lambda p: p.cpu(), params),
                            {"tokens": toks}, activ_dtype=torch.float32)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    caches = api.init_decode(2, 64, torch.float32, device="cuda")
    for t in range(64):
        lt, caches = api.decode_step(params, caches,
                                     {"tokens": toks[:, t].cuda()},
                                     activ_dtype=torch.float32)
        np.testing.assert_allclose(lt.cpu().numpy(), got[:, t].cpu().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")
    bf16, _ = split_tree(api.init(torch.Generator("cuda").manual_seed(3),
                                  dtype=torch.bfloat16))
    before = launches()
    sm90 = fkernel.flash_attention.launches_sm90
    with torch.inference_mode():
        logits, _, _ = api.logits(bf16, {"tokens": toks.cuda()},
                                  last_only=True)
    torch.cuda.synchronize()
    assert launches() - before == attn_calls
    assert fkernel.flash_attention.launches_sm90 - sm90 == attn_calls
    assert bool(torch.isfinite(logits).all())
