"""The port's training slice against the reference, on the CPU.

Both packages run from the same weights and train state (the reference's,
carried across by `convert.params_from_numpy` and
`convert.train_state_from_numpy`) and the same tokens (numpy, fixed
seeds), at the reference's reduced sizes, in float32.  Tolerances:

  * `lm_loss` within 1e-5 (relative) of `jax.value_and_grad(api.loss)`,
    every leaf's gradient within atol 1e-5 / rtol 1e-4 (XLA and torch sum
    the matmuls, softmaxes and scatter-adds in other orders), the new
    router queues equal (the same picks give the same counts);
  * the remat modes against none within 1e-6 (the same arithmetic run
    again);
  * the two autograd Functions' gradients within 1e-5 of autograd of the
    plain versions and of `jax.vjp` of the reference's formulations.

The train step, the launcher and the ports of `tests/test_system.py`'s
training tests are in `tests/test_torch_train_step.py`; the card's own
check of a training step in `tests/test_torch_train_gpu.py` (which needs
no JAX).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.router import RouterState as JRouterState  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.router import RouterState  # noqa: E402
from repro_torch.kernels.bp_topk.ops import bp_topk_route_fn  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_fn, flash_attention_ref)
from repro_torch.kernels.bp_topk import kernel as tkernel  # noqa: E402
from repro_torch.models import get_model, moe as tmoe  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "qwen2-0.5b",
         "olmo-1b")
B, S = 2, 16


def configs(arch, **over):
    return (tconfigs.reduced(tconfigs.get_config(arch), **over),
            jconfigs.reduced(jconfigs.get_config(arch), **over))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tokens(cfg, seed=0, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, S + 1)).astype(np.int32)


def router_H(cfg, seed=5):
    if cfg.family != "moe":
        return None
    return np.random.default_rng(seed).integers(
        0, 4, (cfg.n_layers, cfg.n_experts)).astype(np.float32)


def port_value_and_grad(tcfg, params, toks, H, remat="none"):
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss, (H_out, metrics) = get_model(tcfg).loss(
        leaves, {"tokens": torch.from_numpy(toks)},
        activ_dtype=torch.float32, remat=remat,
        router_H=None if H is None else torch.from_numpy(H))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss, H_out, metrics, grads


def assert_grads_close(ours, ref, rtol=1e-4, atol=1e-5):
    ref = jax.tree_util.tree_leaves(ref)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Config, norm and loss pieces
# ---------------------------------------------------------------------------

def test_olmo_config_is_the_references():
    import dataclasses
    for t, j in ((tconfigs.get_config("olmo-1b"),
                  jconfigs.get_config("olmo-1b")), configs("olmo-1b")):
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(t) == {k: jd[k] for k in
                                         dataclasses.asdict(t)}


def test_layernorm_and_cross_entropy_match_reference():
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.layernorm_nonparam(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.layernorm_nonparam(jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    logits = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        ours = tcommon.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        ref = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    tcfg, jcfg = configs(arch)
    jparams, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(1)))
    toks, H = tokens(tcfg), router_H(tcfg)

    def jloss(p):
        return jget_model(jcfg).loss(
            p, {"tokens": jnp.asarray(toks)}, activ_dtype=jnp.float32,
            remat="none", router_H=None if H is None else jnp.asarray(H))
    (jl, (jH, jm)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss, H_out, metrics, grads = port_value_and_grad(
        tcfg, params_from_numpy(to_numpy(jparams), "cpu"), toks, H)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(jm["ce"]),
                               rtol=1e-5)
    assert_grads_close(grads, jg)
    assert all(float(g.abs().max()) > 0 for g in grads)
    if H is None:
        assert H_out is None and jH is None
    else:
        np.testing.assert_array_equal(H_out.numpy(), np.asarray(jH))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmo-1b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_modes_give_the_same_loss_and_gradients(arch, remat):
    tcfg, jcfg = configs(arch)
    params, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(2)))
    params = params_from_numpy(to_numpy(params), "cpu")
    toks, H = tokens(tcfg, seed=4), router_H(tcfg)
    base = port_value_and_grad(tcfg, params, toks, H, remat="none")
    calls = []
    original = tkernel.bp_topk_route

    def counting(*a, **kw):
        calls.append(1)
        return original(*a, **kw)
    tkernel.bp_topk_route = counting
    import repro_torch.kernels.bp_topk.ops as tops
    tops.bp_topk_route = counting
    try:
        got = port_value_and_grad(tcfg, params, toks, H, remat=remat)
    finally:
        tkernel.bp_topk_route = original
        tops.bp_topk_route = original
    if tcfg.family == "moe":
        # each block's forward runs again in the backward: twice the gates
        assert len(calls) == 2 * tcfg.n_layers
        assert torch.equal(got[1], base[1])      # H updated once, the same
    np.testing.assert_allclose(float(got[0]), float(base[0]), rtol=1e-6)
    for a, b in zip(got[3], base[3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        port_value_and_grad(tcfg, params, toks, H, remat="everything")


# ---------------------------------------------------------------------------
# The autograd Functions around the two kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,dtype", [
    (True, None, "float32"), (True, 5, "float32"), (False, None, "float32"),
    (True, None, "bfloat16")])
def test_flash_attention_fn_gradients(causal, window, dtype):
    """`FlashAttentionFn` on the CPU against autograd of the plain version
    and against `jax.vjp` of the reference's `sdpa` (float32 only: the
    reference's bf16 sdpa rounds its products to bf16)."""
    rng = np.random.default_rng(7)
    Bq, H, KH, T, D = 2, 4, 2, 12, 16
    q = rng.standard_normal((Bq, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, T, KH, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((Bq, T, H, D)).astype(np.float32)
    dt = getattr(torch, dtype)
    qkv = [torch.from_numpy(a).to(dt).transpose(1, 2).requires_grad_()
           for a in (q, k, v)]
    out = flash_attention_fn(*qkv, causal=causal, window=window)
    ours = torch.autograd.grad(out, qkv, torch.from_numpy(g).to(
        dt).transpose(1, 2))
    # the plain version's float32 gradient on the same values, rounded
    # once to the inputs' dtype
    plain = [t.detach().float().requires_grad_() for t in qkv]
    want = torch.autograd.grad(flash_attention_ref(
        *plain, causal=causal, window=window), plain, torch.from_numpy(
        g).to(dt).float().transpose(1, 2))
    for a, b in zip(ours, want):
        assert a.dtype == dt and torch.equal(a, b.to(dt))
    if dtype != "float32":
        return
    pos = jnp.broadcast_to(jnp.arange(T)[None], (Bq, T))
    mask = jattn._mask(pos, pos, causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jattn.sdpa(a, b, c, mask),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(ours, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("router", ["backpressure", "aux"])
def test_gate_fn_gradients(router):
    """`_route`'s kernel branch under autograd (`BpTopkRouteFn`) against
    its plain branch's autograd and `jax.vjp` of the reference's `_route`
    weights (and aux loss), with respect to the tokens and the router."""
    full = tconfigs.get_config("granite-moe-1b-a400m")
    tcfg, jcfg = configs("granite-moe-1b-a400m", n_experts=full.n_experts,
                         top_k=full.top_k, router=router)
    jp, _ = jsplit(jmoe.init_moe(jcfg, jcommon_init(1)))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    H = rng.integers(0, 5, tcfg.n_experts).astype(np.float32)
    r = rng.standard_normal((2, 8, tcfg.top_k)).astype(np.float32)

    def port(use_kernel):
        p = params_from_numpy(to_numpy(jp), "cpu")
        xt = torch.from_numpy(x).requires_grad_()
        p["router"].requires_grad_()
        rs = RouterState(H=torch.from_numpy(H),
                         steps=torch.zeros((), dtype=torch.int32))
        idx, w, _, aux, _ = tmoe._route(tcfg, p, xt, rs,
                                        use_kernel=use_kernel)
        obj = (w * torch.from_numpy(r)).sum() + aux
        return idx, torch.autograd.grad(obj, (xt, p["router"]))

    idx_k, g_k = port(True)
    idx_p, g_p = port(False)
    assert torch.equal(idx_k, idx_p)
    for a, b in zip(g_k, g_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)

    def ref(xj, wr):
        p = dict(jp, router=wr)
        rs = JRouterState(H=jnp.asarray(H), steps=jnp.zeros((), jnp.int32))
        _, w, _, aux, _ = jmoe._route(jcfg, p, xj, rs)
        return (w * jnp.asarray(r)).sum() + aux
    jg = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x), jp["router"])
    for a, b in zip(g_k, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def jcommon_init(seed):
    from repro.models import common as jcommon
    return jcommon.Init(key=jax.random.key(seed))


def test_gate_fn_closed_form_equals_autograd_of_plain():
    """`BpTopkRouteFn`'s backward on [T, E] logits against autograd of
    softmax -> picked probabilities -> renormalised, bf16 logits too."""
    rng = np.random.default_rng(11)
    T, E, k = 40, 32, 8
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.from_numpy(rng.standard_normal((T, E)).astype(
            np.float32) * 2).to(dtype).requires_grad_()
        H = torch.from_numpy(rng.integers(0, 9, E).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((T, k)).astype(np.float32))
        idx, w, counts, H_new, steps = bp_topk_route_fn(
            logits, H, torch.zeros((), dtype=torch.int32), T * k / E, k, True)
        assert not (idx.requires_grad or counts.requires_grad
                    or H_new.requires_grad)
        (ours,) = torch.autograd.grad(w, logits, g.to(dtype))
        lp = logits.detach().requires_grad_()
        p = torch.softmax(lp.float(), -1)
        picked = torch.gather(p, 1, idx)
        wp = picked / picked.sum(-1, keepdim=True)
        (want,) = torch.autograd.grad(wp, lp, g)
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(ours.float().numpy(),
                                   want.float().numpy(), rtol=tol,
                                   atol=tol)
