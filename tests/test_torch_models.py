"""The port's MoE serving slice against the reference, on the CPU.

Both packages run on the same weights (the reference's, carried across by
`convert.params_from_numpy`) and the same inputs (numpy, fixed seeds), at
the reference's reduced sizes.  Tolerances: routing picks the same experts
exactly; router state and MoE outputs within 1e-5 (XLA and torch sum the
softmax, the matmuls and the combine in other orders); decode logits over
8 steps within rtol 1e-4 / atol 1e-5 (the same rounding, carried through
the layers and the cache).  The serving engine must emit the same tokens,
except after a near-tie (top-two logits within 1e-5) that rounding may
flip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.router import RouterState as JRouterState  # noqa: E402
from repro.launch.serve import Engine as JEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.router import RouterState  # noqa: E402
from repro_torch.kernels.bp_topk import kernel as tkernel  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import get_model, moe as tmoe, split_tree  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "qwen2-0.5b")


def configs(arch, **over):
    """(port config, reference config), reduced, with the same overrides."""
    return (tconfigs.reduced(tconfigs.get_config(arch), **over),
            jconfigs.reduced(jconfigs.get_config(arch), **over))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(jcfg, seed=1):
    values, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(seed)))
    return values


def moe_params(jcfg, seed=1):
    values, _ = jsplit(jmoe.init_moe(jcfg, jcommon.Init(
        key=jax.random.key(seed))))
    return values, params_from_numpy(to_numpy(values), "cpu")


# ---------------------------------------------------------------------------
# Configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    tfull, jfull = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for t, j in ((tfull, jfull), configs(arch)):
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(t) == {k: jd[k] for k in
                                         dataclasses.asdict(t)}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-0.5b"])
def test_init_tree_matches_reference_shapes_and_axes(arch):
    tcfg, jcfg = configs(arch)
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tvals))[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda s: tuple(s.shape), jvals))[0])
    assert flat_t == flat_j
    assert taxes == jaxes
    w = tvals["stack"]["layers"]["attn"]["wq"]          # fan-in d_model
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tcfg.d_model) + 1e-7
    assert float(w.std()) > 0.5 / np.sqrt(tcfg.d_model)


def test_unported_families_raise():
    """Every family of the reference is ported: an unknown family still
    raises in `get_model`, and the hybrid and ssm configs resolve to their
    modules."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(
        "qwen2-0.5b")), family="recurrent")
    with pytest.raises(KeyError, match="unknown family 'recurrent'"):
        get_model(cfg)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("xlstm-7b")
    from repro_torch.models import xlstm, zamba
    for arch, mod in (("xlstm-350m", xlstm), ("zamba2-2.7b", zamba)):
        assert get_model(tconfigs.get_config(arch)).mod is mod
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------

def test_rope_mask_and_sdpa_match_reference():
    rng = np.random.default_rng(0)
    B, S, T, H, KH, D = 2, 5, 9, 4, 2, 16
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 50, (B, S)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e4).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e4)), rtol=1e-5, atol=1e-5)
    qp = np.arange(S, dtype=np.int32)[None].repeat(B, 0) + 4
    kp = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    for causal, window in ((True, None), (True, 3), (False, None)):
        tm = tattn._mask(torch.from_numpy(qp), torch.from_numpy(kp),
                         causal=causal, window=window)
        jm = jattn._mask(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                         window=window)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KH, D)).astype(np.float32)
            for _ in range(2))
    m = np.array(jattn._mask(jnp.asarray(qp), jnp.asarray(kp), causal=True,
                             window=3))
    m[0, 0] = False                                    # a row with no key
    out = tattn.sdpa(*(torch.from_numpy(a) for a in (q, k, v, m)))
    want = jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v, m)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# MoE routing and FFN
# ---------------------------------------------------------------------------

def test_kernel_routing_equals_einsum_path():
    """The port's mirror of tests/test_kernels.py's kernel-backed routing
    parity: `_route(use_kernel=True)` == `use_kernel=False`."""
    tcfg, jcfg = configs("moonshot-v1-16b-a3b")
    _, p = moe_params(jcfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    rs = RouterState(H=torch.arange(tcfg.n_experts, dtype=torch.float32),
                     steps=torch.zeros((), dtype=torch.int32))
    a = tmoe._route(tcfg, p, x, rs, use_kernel=False)
    b = tmoe._route(tcfg, p, x, rs, use_kernel=True)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("router", ["backpressure", "plain", "aux"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_kernel_branch_equals_plain_branch(arch, router, dtype):
    """The port's `_route(use_kernel=True)` (one `bp_topk_route`) against
    its ``use_kernel=False`` branch, at the full configs' expert counts
    (granite 32 top-8, moonshot 64 top-6), non-zero H: the same experts,
    counts, H and steps; weights within rtol 1e-5 / atol 1e-6 in float32
    (the softmax sums in another order) or one bf16 ulp; aux within
    1e-6."""
    full = tconfigs.get_config(arch)
    tcfg, jcfg = configs(arch, n_experts=full.n_experts, top_k=full.top_k,
                         router=router)
    _, p = moe_params(jcfg)
    rng = np.random.default_rng(9)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal(
        (2, 8, tcfg.d_model)).astype(np.float32)).to(dt)
    rs = RouterState(H=torch.from_numpy(
        rng.integers(0, 5, tcfg.n_experts).astype(np.float32)),
        steps=torch.tensor(2, dtype=torch.int32))
    a = tmoe._route(tcfg, p, x, rs, use_kernel=False)
    b = tmoe._route(tcfg, p, x, rs, use_kernel=True)
    assert torch.equal(a[0], b[0]) and a[0].dtype == torch.int64
    assert a[1].dtype == b[1].dtype == dt
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2.0 ** -7, atol=0)
    np.testing.assert_allclose(a[1].float().numpy(), b[1].float().numpy(),
                               **tol)
    assert torch.equal(a[2].H, b[2].H) and torch.equal(a[2].steps,
                                                        b[2].steps)
    assert int(b[2].steps) == 3 and b[2].steps.dtype == torch.int32
    np.testing.assert_allclose(a[3].numpy(), b[3].numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(a[4], b[4])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "granite-moe-1b-a400m"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_route_matches_reference(arch, use_kernel):
    tcfg, jcfg = configs(arch)
    jp, tp = moe_params(jcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 8, tcfg.d_model)).astype(np.float32)
    H = (rng.random(tcfg.n_experts) * 4).astype(np.float32)
    out = tmoe._route(tcfg, tp, torch.from_numpy(x), RouterState(
        torch.from_numpy(H), torch.zeros((), dtype=torch.int32)),
        use_kernel=use_kernel)
    want = jmoe._route(jcfg, jp, jnp.asarray(x), JRouterState(
        jnp.asarray(H), jnp.zeros((), jnp.int32)), use_kernel=use_kernel)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[2].H.numpy(), np.asarray(want[2].H),
                               atol=1e-5)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("dropless,capacity_factor", [(True, 4.0),
                                                      (False, 4.0),
                                                      (False, 0.5)])
def test_moe_ffn_matches_reference(dropless, capacity_factor):
    tcfg, jcfg = configs("granite-moe-1b-a400m",
                         capacity_factor=capacity_factor)
    jp, tp = moe_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    H = (rng.random(tcfg.n_experts) * 2).astype(np.float32)
    trs = RouterState(torch.from_numpy(H), torch.zeros((),
                                                       dtype=torch.int32))
    y, st, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x), trs,
                            dropless=dropless)
    jy, jst, _ = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), JRouterState(
        jnp.asarray(H), jnp.zeros((), jnp.int32)), dropless=dropless)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(jst.H), atol=1e-5)
    if capacity_factor < 1:                 # the overflow sink was used
        idx = tmoe._route(tcfg, tp, torch.from_numpy(x), trs)[0]
        per_group = [torch.bincount(g.reshape(-1), minlength=8) for g in idx]
        cap = int(np.ceil(16 * tcfg.top_k / tcfg.n_experts * 0.5))
        assert max(int(c.max()) for c in per_group) > cap
    # the kernel branch gives the same FFN output
    yk, _, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x), trs,
                            dropless=dropless, use_kernel=True)
    np.testing.assert_allclose(yk.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "moonshot-v1-16b-a3b"])
def test_moe_ffn_kernel_branch_matches_reference(arch):
    """The MoE FFN routed through the fused gate (`bp_topk_route`'s plain
    version on the CPU) against the reference's `moe_ffn`, at the full
    configs' expert counts: outputs within 1e-5, H' within 1e-5, steps
    equal."""
    full = tconfigs.get_config(arch)
    tcfg, jcfg = configs(arch, n_experts=full.n_experts, top_k=full.top_k)
    jp, tp = moe_params(jcfg)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    H = (rng.random(tcfg.n_experts) * 2).astype(np.float32)
    y, st, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x), RouterState(
        torch.from_numpy(H), torch.zeros((), dtype=torch.int32)),
        use_kernel=True)
    jy, jst, _ = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), JRouterState(
        jnp.asarray(H), jnp.zeros((), jnp.int32)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.H.numpy(), np.asarray(jst.H), atol=1e-5)
    assert int(st.steps) == int(jst.steps) == 1


# ---------------------------------------------------------------------------
# Decode step and serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-0.5b"])
def test_lm_decode_step_matches_reference_over_8_steps(arch):
    tcfg, jcfg = configs(arch)
    jparams = jax_params(jcfg)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    B, max_len = 3, 16
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jc = japi.init_decode(B, max_len, jnp.float32)
    tc = tapi.init_decode(B, max_len, torch.float32, device="cpu")
    jH = japi.init_state().router_H
    tH = tapi.init_state(device="cpu").router_H
    jstep = jax.jit(lambda p, c, t, H: japi.decode_step(
        p, c, {"tokens": t}, activ_dtype=jnp.float32, router_H=H))
    rng = np.random.default_rng(5)
    before = tkernel.bp_topk.launches
    route_before = tkernel.bp_topk_route.launches
    for _ in range(8):
        toks = rng.integers(0, tcfg.vocab, B).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(toks), jH)
        tl, tc = tapi.decode_step(tparams, tc,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  activ_dtype=torch.float32, router_H=tH)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(tc["layers"].kpos.numpy(),
                                  np.asarray(jc["layers"].kpos))
    np.testing.assert_allclose(tc["layers"].k.numpy(),
                               np.asarray(jc["layers"].k), rtol=1e-4,
                               atol=1e-5)
    assert int(tc["layers"].pos[0]) == 8
    assert tkernel.bp_topk.launches == before      # CPU: plain version
    assert tkernel.bp_topk_route.launches == route_before


def test_lm_decode_step_at_granites_gate_matches_reference():
    """granite at 3 layers with its full gate (32 experts top-8), non-zero
    router queues: 4 decode steps through `bp_topk_route` (plain version
    on the CPU) against the reference's, logits within rtol 1e-4 / atol
    1e-5."""
    tcfg, jcfg = configs("granite-moe-1b-a400m", n_layers=3, n_experts=32,
                         top_k=8)
    jparams = jax_params(jcfg)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    B, max_len = 4, 8
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jc = japi.init_decode(B, max_len, jnp.float32)
    tc = tapi.init_decode(B, max_len, torch.float32, device="cpu")
    rng = np.random.default_rng(13)
    H = (rng.random((3, 32)) * 3).astype(np.float32)
    jstep = jax.jit(lambda p, c, t, H: japi.decode_step(
        p, c, {"tokens": t}, activ_dtype=jnp.float32, router_H=H))
    for _ in range(4):
        toks = rng.integers(0, tcfg.vocab, B).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(toks), jnp.asarray(H))
        tl, tc = tapi.decode_step(tparams, tc,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  activ_dtype=torch.float32,
                                  router_H=torch.from_numpy(H))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)


def test_engine_emits_the_references_tokens():
    tcfg, jcfg = configs("granite-moe-1b-a400m")
    jparams = jax_params(jcfg, seed=0)
    tparams = params_from_numpy(to_numpy(jparams), "cpu")
    jeng = JEngine(jcfg, jparams, slots=2, max_len=64)
    teng = tserve.Engine(tcfg, tparams, slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        prompt = list(rng.integers(0, tcfg.vocab, int(rng.integers(4, 16))))
        assert jeng.submit(prompt, 6) == teng.submit(prompt, 6)
    last = {"calls": 0}
    jstep = jeng._step

    def recording_step(*args):
        logits, caches = jstep(*args)
        last["logits"] = np.asarray(logits)
        last["calls"] += 1
        return logits, caches
    jeng._step = recording_step

    def admitted(eng):
        return {r.rid: r for r in list(eng.finished.values()) +
                [r for r in eng.slot_req if r is not None]}
    slot_of, diverged = {}, set()
    while jeng.pending or any(r is not None for r in jeng.slot_req):
        jeng.step()
        teng.step()
        for s, r in enumerate(jeng.slot_req):
            if r is not None:
                slot_of[r.rid] = s
        jreqs, treqs = admitted(jeng), admitted(teng)
        assert jreqs.keys() == treqs.keys()
        for rid, jr in jreqs.items():
            if rid in diverged or jr.out == treqs[rid].out:
                continue
            # this tick's token differs: allowed only at a near-tie
            top2 = np.sort(last["logits"][slot_of[rid]])[-2:]
            assert top2[1] - top2[0] < 1e-5, (rid, jr.out, treqs[rid].out)
            diverged.add(rid)
    assert sorted(jeng.finished) == sorted(teng.finished) == [0, 1, 2]
    assert all(len(r.out) == 6 for r in teng.finished.values())
    assert len(diverged) < 3
    assert teng.steps == last["calls"]         # prefill steps and ticks


def test_engine_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tcfg, _ = configs("granite-moe-1b-a400m")
    params, _ = split_tree(get_model(tcfg).init(torch.Generator()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Engine(tcfg, params)


def test_model_api_state_and_caches_default_to_cuda(monkeypatch):
    """`init_state` and `init_decode` resolve their device like every
    other entry point: CUDA unless asked, raising without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(configs("granite-moe-1b-a400m")[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_decode(2, 8, torch.float32)
    assert api.init_state(device="cpu").router_H.device.type == "cpu"
    caches = api.init_decode(2, 8, torch.float32, device="cpu")
    assert caches["layers"].k.device.type == "cpu"


def test_serve_cli_on_the_cpu(capsys):
    finished = tserve.main(["--arch", "granite-moe-1b-a400m", "--device",
                            "cpu", "--requests", "3", "--slots", "2",
                            "--max-new", "4"])
    assert sorted(finished) == [0, 1, 2]
    assert all(len(r.out) == 4 for r in finished.values())
    assert "served 3 requests" in capsys.readouterr().out


def test_temperature_sampling_is_seeded():
    tcfg, _ = configs("granite-moe-1b-a400m")
    params, _ = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    outs = []
    for seed in (3, 3, 4):
        eng = tserve.Engine(tcfg, params, slots=2, max_len=32,
                            temperature=1.0, seed=seed, device="cpu")
        for prompt in ([5, 6, 7], [9, 10]):
            eng.submit(prompt, 8)
        outs.append({r: f.out for r, f in eng.run_until_done().items()})
    assert outs[0] == outs[1]                   # the engine's own generator
    assert outs[0] != outs[2]
    assert all(0 <= t < tcfg.vocab for o in outs[0].values() for t in o)
