"""Moonlight-16B-A3B's block in the port (`configs.moonlight_16b_a3b`):
latent attention, the gate's sigmoid mode, shared experts and the leading
dense layer, each held on the CPU to the benchmark's plain reference
(`portbench/reference/moonlight.py`, plain float32 torch that imports
nothing of the port) on seeded random weights, at a tiny cut: 2 layers
(the dense one and one MoE), d 64, 4 heads of q/k 24 (16 + 8) and v 16,
latent 32, 8 experts top-2 plus 1 shared, float32.

Both sides compute in float32 on the same weights, so they differ by the
order of their sums only: 1e-5 of the largest magnitude (the sums' rounding
reads ~1e-7; the reference computed in float8 reads ~0.2 at the cell's
size).  The gate's picks must agree exactly and its weights within 1e-6.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import moonlight as ref  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.moonlight_16b_a3b import MLAConfig  # noqa: E402
from repro_torch.core.router import RouterState  # noqa: E402
from repro_torch.kernels.bp_topk import kernel as gate_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import get_model, moe, split_tree  # noqa: E402
from repro_torch.runtime import flags  # noqa: E402

NAME = "moonlight-16b-a3b"
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
            d_ff=16, vocab=256, n_experts=8, top_k=2, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_shared_experts=1, first_dense_layers=1, dense_d_ff=96)
B, S = 2, 48


def tiny(**over) -> MLAConfig:
    return dataclasses.replace(tconfigs.get_config(NAME), **{**TINY, **over})


def ref_config(cfg: MLAConfig) -> dict:
    """The reference's view of ``cfg``: its `port` section, float32
    weights."""
    return {"port": dataclasses.asdict(cfg), "torch_dtype": "float32"}


def draw(cfg: MLAConfig, seed: int):
    """(reference weights, the port's tree of the same tensors, tokens)."""
    gen = torch.Generator().manual_seed(seed)
    W = ref.weights(ref_config(cfg), gen)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    return W, ref.program_params(W), tokens


def layer(tree: dict, i: int) -> dict:
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def close(got, want, tol=1e-5):
    err = float((got - want).abs().max() / want.abs().max())
    assert err < tol, err


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("seed", [0, 7])
def test_mla_attention_matches_the_reference(impl, seed):
    cfg = tiny()
    W, P, _ = draw(cfg, seed)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(seed + 1))
    pos = torch.arange(S)[None].expand(B, S)
    z = ref.dims(ref_config(cfg))
    for i, stack in ((0, P["stack"]["dense"]), (1, P["stack"]["layers"])):
        with flags.attention_impl(impl):
            got = tattention.mla_attention(cfg, layer(stack, 0)["attn"], x,
                                           pos)
        w = {n: W[n][i] for n in ref.ATTENTION}
        want = torch.stack([ref.attention(x[b], w, z, cfg.rope_theta,
                                          cfg.norm_eps) for b in range(B)])
        close(got, want)


def test_mla_is_causal_and_its_rope_key_is_shared():
    """A change at position t moves no output before t; k's last Dr
    columns are one rotated key in every head."""
    cfg = tiny()
    _, P, _ = draw(cfg, 3)
    p = layer(P["stack"]["layers"], 0)["attn"]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1, S, cfg.d_model), generator=gen)
    pos = torch.arange(S)[None]
    y = tattention.mla_attention(cfg, p, x, pos)
    x2 = x.clone()
    x2[0, S // 2] += 1.0
    y2 = tattention.mla_attention(cfg, p, x2, pos)
    assert torch.equal(y[:, :S // 2], y2[:, :S // 2])
    assert not torch.equal(y[:, S // 2:], y2[:, S // 2:])
    q, k, v = tattention._mla_qkv(cfg, p, x, pos)
    Dn = cfg.qk_nope_head_dim
    assert q.shape[-1] == k.shape[-1] == 24 and v.shape[-1] == 16
    assert torch.equal(k[..., Dn:], k[:, :, :1, Dn:].expand_as(k[..., Dn:]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_sigmoid_gate_matches_the_reference(use_kernel, seed):
    """Both branches of `moe._route` (the kernel's branch runs its plain
    version on the CPU): the reference's picks, weights within 1e-6, the
    queues' update from the picks, with H zero and with a random H (the
    selection-only bias)."""
    cfg = tiny()
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    p = {"router": torch.randn((cfg.d_model, cfg.n_experts),
                               generator=gen) * 0.3}
    for H in (torch.zeros(cfg.n_experts),
              torch.rand(cfg.n_experts, generator=gen) * 8):
        rs = RouterState(H=H, steps=torch.zeros((), dtype=torch.int32))
        idx, w, new, _, counts = moe._route(cfg, p, x, rs,
                                            use_kernel=use_kernel)
        logits = (x @ p["router"]).reshape(B * S, -1)
        picks, want = ref.gate(logits, H, cfg.top_k, cfg.routed_scale)
        assert torch.equal(idx.reshape(B * S, -1), picks)
        torch.testing.assert_close(w.reshape(B * S, -1), want, rtol=0,
                                   atol=1e-6)
        cap = B * S * cfg.top_k / cfg.n_experts
        assert torch.equal(new.H, torch.clamp(H + counts - cap, min=0.0))
        assert float(w.sum(-1).mean()) == pytest.approx(cfg.routed_scale,
                                                        rel=1e-6)


def test_sigmoid_mode_of_the_gate_kernel_wrapper():
    """The wrapper's plain version in the sigmoid mode: each logit's
    sigmoid, the picks' over their sum times the scale; an unknown mode is
    refused."""
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((33, 64), generator=gen)
    H = torch.rand(64, generator=gen)
    steps = torch.zeros((), dtype=torch.int32)
    idx, w, counts, H_new, st = gate_kernel.bp_topk_route(
        logits, H, steps, 33 * 6 / 64, 6, True, score="sigmoid", scale=2.5)
    probs = torch.sigmoid(logits)
    sel = probs - H / max(33 * 6 / 64, 1.0)
    want = torch.sort(sel, dim=-1, descending=True,
                      stable=True).indices[:, :6]
    assert torch.equal(idx, want)
    pk = torch.gather(probs, 1, want)
    torch.testing.assert_close(w, pk / pk.sum(-1, keepdim=True) * 2.5,
                               rtol=0, atol=1e-6)
    assert int(counts.sum()) == 33 * 6 and int(st) == 1
    with pytest.raises(ValueError, match="score"):
        gate_kernel.bp_topk_route(logits, H, steps, 1.0, 6, True,
                                  score="relu")


@pytest.mark.parametrize("seed", [0, 11])
def test_moe_layer_with_shared_experts_matches_the_reference(seed):
    """The routed experts (capacity drops included) plus the shared
    SwiGLU, unweighted; without the shared experts the layer differs."""
    cfg = tiny(capacity_factor=1.0)
    W, P, _ = draw(cfg, seed)
    p = layer(P["stack"]["layers"], 0)["moe"]
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(seed + 2))
    H = torch.zeros(cfg.n_experts)
    rs = RouterState(H=H, steps=torch.zeros((), dtype=torch.int32))
    got, _, _ = moe.moe_ffn(cfg, p, x, rs, use_kernel=True)
    m = {n: W[n][0] for n in ref.MOE}
    picks, w = ref.gate((x @ m["router"]).reshape(B * S, -1), H,
                        cfg.top_k, cfg.routed_scale)
    per_row = torch.nn.functional.one_hot(picks.reshape(B, -1),
                                          cfg.n_experts).sum(1)
    assert int(per_row.max()) > S * cfg.top_k // cfg.n_experts   # drops
    routed = ref.experts(x, picks.view(B, S, -1), w.view(B, S, -1),
                         m["gate"], m["up"], m["down"], cfg.capacity_factor)
    shared = ref.swiglu(x, m["shared_gate"], m["shared_up"],
                        m["shared_down"])
    close(got, routed + shared)
    assert (got - routed).abs().max() > 1e-3


@pytest.mark.parametrize("seed", [0, 5, 2_147_483_999])
def test_prefill_last_rows_match_the_reference(seed):
    """The whole prefill through `runtime.step.make_prefill_step` (the
    dense layer, then the MoE layer, untied head), float32 activations:
    every prompt's last-position logits within 1e-5 of the reference's."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.runtime.step import make_prefill_step
    cfg = tiny()
    W, P, tokens = draw(cfg, seed)
    api = get_model(cfg)
    H0 = api.init_state(device="cpu").router_H
    assert tuple(H0.shape) == (1, cfg.n_experts)
    step = make_prefill_step(RunConfig(cfg, ShapeConfig("t", S, B, "prefill"),
                                       activ_dtype="float32"))
    got = step(P, {"tokens": tokens}, H0)[:, -1]
    want, _ = ref.forward(ref_config(cfg), W, tokens, H0)
    for b in range(B):
        close(got[b], want[b])
    _, H, _ = api.logits(P, {"tokens": tokens}, activ_dtype=torch.float32,
                         router_H=H0)
    assert tuple(H.shape) == (1, cfg.n_experts) and float(H.sum()) > 0


def test_the_held_reference_takes_the_programs_picks():
    """In float32 the program picks what the reference picks: held to the
    program's recorded picks the reference gives its own logits with a
    shortfall of 0; a last row's pick swapped for an expert outside the
    reference's top k leaves a shortfall above 0 at that token alone and
    moves that row."""
    from portbench.entries.prefill import _patched
    cfg = tiny()
    W, P, tokens = draw(cfg, 4)
    api = get_model(cfg)
    H0 = api.init_state(device="cpu").router_H
    got = []

    def wrap(real):
        def route(*a, **kw):
            out = real(*a, **kw)
            got.append(out[0].clone())
            return out
        return route
    with _patched("repro_torch.models.moe", "_route", wrap):
        api.logits(P, {"tokens": tokens}, activ_dtype=torch.float32,
                   router_H=H0)
    want, own = ref.forward(ref_config(cfg), W, tokens, H0)
    assert len(got) == len(own) == 1 and torch.equal(got[0], own[0])
    held, short = ref.forward_held(ref_config(cfg), W, tokens, H0, got)
    assert float(short.amax()) == 0.0 and torch.equal(held, want)
    bad = got[0].clone()
    taken = set(bad[0, -1].tolist())
    bad[0, -1, -1] = next(e for e in range(cfg.n_experts) if e not in taken)
    held, short = ref.forward_held(ref_config(cfg), W, tokens, H0, [bad])
    assert float(short[0, 0, -1]) > 0 and float(short.amax()) == float(
        short[0, 0, -1]) and not torch.equal(held[0], want[0])


def test_the_ports_init_has_the_references_tree():
    """The port's own init gives the tree and shapes the reference hands
    it; at full size the reference draws 15,960,108,544 weights."""
    cfg = tiny()
    _, P, _ = draw(cfg, 0)
    own, _ = split_tree(get_model(cfg).init(torch.Generator().manual_seed(0)))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    assert shapes(own) == shapes(P)
    full = ref_config(tconfigs.get_config(NAME))
    assert sum(torch.Size(s).numel() for _, s, _ in ref.layout(full)) == \
        15_960_108_544


def test_the_registry_finds_the_port_only_config():
    """`get_config` resolves moonlight-16b-a3b; `ARCHS`, `cells()` and the
    base `ModelConfig`'s fields are the JAX package's; the old
    moonshot-v1-16b-a3b entry is unchanged."""
    from repro import configs as jconfigs
    cfg = tconfigs.get_config(NAME)
    assert isinstance(cfg, MLAConfig) and cfg.family == "moe"
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab,
            cfg.n_experts, cfg.top_k, cfg.d_ff) == (27, 2048, 16, 163840,
                                                    64, 6, 1408)
    assert NAME not in tconfigs.ARCHS
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert tconfigs.cells() == jconfigs.cells()
    assert all(n != NAME for n, _ in tconfigs.cells(include_skipped=True))
    base = [f.name for f in dataclasses.fields(tconfigs.ModelConfig)]
    assert base == [f.name for f in dataclasses.fields(
        jconfigs.ModelConfig)]
    old = tconfigs.get_config("moonshot-v1-16b-a3b")
    assert type(old) is tconfigs.ModelConfig and old.n_layers == 48
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("moonlight-17b")


def test_decode_of_an_mla_config_is_refused():
    api = get_model(tiny())
    with pytest.raises(NotImplementedError, match="latent"):
        api.init_decode(2, 16, torch.float32, device="cpu")


def test_cores_take_v_with_its_own_head_dim():
    """`sdpa`, `sdpa_chunked` and the flash wrapper's plain version on q/k
    of 24 and v of 16: [B, S, H, 16] out, in agreement."""
    gen = torch.Generator().manual_seed(9)
    q = torch.randn((B, S, 4, 24), generator=gen)
    k = torch.randn((B, S, 2, 24), generator=gen)
    v = torch.randn((B, S, 2, 16), generator=gen)
    pos = torch.arange(S)[None].expand(B, S)
    a = tattention.sdpa(q, k, v, tattention._mask(pos, pos, causal=True,
                                                  window=None))
    c = tattention.sdpa_chunked(q, k, v, pos, pos, causal=True, window=None,
                                chunk_q=16, chunk_k=16)
    f = fkernel.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
    assert a.shape == c.shape == f.shape == (B, S, 4, 16)
    close(c, a)
    close(f, a)


def test_flash_dispatch_names_the_mla_instance():
    """bfloat16 (192, 128) runs the sm90 kernel; float32 at (192, 128), and
    v dims the kernels do not instantiate, are refused by name."""
    assert (192, 128) in fkernel.HEAD_DIMS_SM90
    assert fkernel.uses_sm90(torch.bfloat16, 192, 128)
    assert fkernel.kernel_for(torch.bfloat16, 192, 128) == "sm90"
    assert fkernel.kernel_for(torch.bfloat16, 64) == "sm90"
    assert not fkernel.uses_sm90(torch.bfloat16, 192)
    for dtype, D, Dv in ((torch.float32, 192, 128), (torch.bfloat16, 128, 64),
                         (torch.float32, 64, 32)):
        with pytest.raises(ValueError, match=f"q/k {D}, v {Dv}"):
            fkernel.kernel_for(dtype, D, Dv)
    q = torch.zeros((1, 2, 8, 24))
    with pytest.raises(ValueError, match="Dv"):
        fkernel.flash_attention(q, q, torch.zeros((1, 2, 7, 16)))
