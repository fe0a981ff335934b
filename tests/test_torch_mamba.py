"""The port's Mamba2 (SSD) block against the reference, on the CPU.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`) and the same inputs (numpy, fixed seeds),
at the reference's reduced sizes, in float32.  Tolerances: outputs and
gradients within rtol 1e-4 / atol 1e-5 (XLA and torch sum in other
orders, and the port's inter-chunk carry is a segment-sum matrix where the
reference runs an associative scan); the chunk sizes against each other
within 2e-4 (`tests/test_models_consistency.py`'s); the decode recurrence
against the chunked forward within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def configs(**over):
    arch = "zamba2-2.7b"
    return (tconfigs.reduced(tconfigs.get_config(arch), **over),
            jconfigs.reduced(jconfigs.get_config(arch), **over))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def weights(jcfg, seed=0):
    jp, _ = jcommon.split_tree(jmamba.init_mamba(
        jcfg, jcommon.Init(key=jax.random.key(seed))))
    # a non-trivial A_log, dt_bias, Dskip and gamma: the reference inits
    # them to constants
    rng = np.random.default_rng(seed + 100)
    jp = dict(jp)
    for name in ("A_log", "dt_bias", "Dskip", "gamma", "conv_b"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(
            jp[name].shape).astype(np.float32))
    return jp, params_from_numpy(to_numpy(jp), "cpu")


def inputs(cfg, B=2, S=32, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_init_tree_shapes_and_axes_match_reference():
    tcfg, jcfg = configs()
    assert tmamba.dims(tcfg) == jmamba.dims(jcfg)
    tv, ta = tcommon.split_tree(tmamba.init_mamba(
        tcfg, tcommon.Init(gen=torch.Generator().manual_seed(0))))
    jv, ja = jcommon.split_tree(jmamba.init_mamba(
        jcfg, jcommon.Init(key=None, abstract=True)))
    assert {k: tuple(v.shape) for k, v in tv.items()} == \
        {k: tuple(v.shape) for k, v in jv.items()}
    assert ta == ja
    assert float(tv["conv_w"].abs().max()) <= 2 * 0.5 + 1e-7
    assert torch.equal(tv["Dskip"], torch.ones_like(tv["Dskip"]))


@pytest.mark.parametrize("S", [32, 37, 16, 5, 1])
def test_mamba_fwd_matches_reference(S):
    """Whole chunks, a ragged tail (padded to the chunk), one chunk, and
    sequences shorter than the chunk."""
    tcfg, jcfg = configs()
    jp, tp = weights(jcfg)
    x = inputs(tcfg, S=S)
    want = jmamba.mamba_fwd(jcfg, jp, jnp.asarray(x))
    got = tmamba.mamba_fwd(tcfg, tp, torch.from_numpy(x))
    assert got.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba_fwd_gradients_match_reference():
    tcfg, jcfg = configs()
    jp, tp = weights(jcfg)
    x = inputs(tcfg, S=37)
    wout = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jmamba.mamba_fwd(jcfg, p, xx) * wout)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tmamba.mamba_fwd(tcfg, leaves, xt) * torch.from_numpy(
        wout)).sum()
    grads = torch.autograd.grad(loss, tree_leaves(leaves) + [xt])
    ref = jax.tree_util.tree_leaves(jg) + [jgx]
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("S", [32, 29])
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunk_invariance(chunk, S):
    """The port's counterpart of `test_mamba_chunk_invariance`: the output
    does not depend on the chunk (within 2e-4 of chunk 4's), and at each
    chunk it is the reference's; S = 29 pads every chunk size."""
    tcfg, jcfg = configs()
    jp, tp = weights(jcfg, seed=2)
    x = inputs(tcfg, S=S, seed=3)
    base = tmamba.mamba_fwd(dataclasses.replace(tcfg, ssm_chunk=4), tp,
                            torch.from_numpy(x))
    got = tmamba.mamba_fwd(dataclasses.replace(tcfg, ssm_chunk=chunk), tp,
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=2e-4,
                               atol=2e-4)
    want = jmamba.mamba_fwd(dataclasses.replace(jcfg, ssm_chunk=chunk), jp,
                            jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_state_passing_is_the_sequential_carry():
    """The segment-sum matrix gives the state entering each chunk as the
    sequential carry S' = a S + chunk_in does, and stays finite with
    strong decays (log a down to -300 a chunk, where prefix sums of the
    log decays would lose every digit)."""
    rng = np.random.default_rng(0)
    B, nC, nh, hd, ns = 2, 9, 3, 4, 5
    for scale in (0.5, 300.0):
        L = torch.from_numpy(-scale * rng.random((B, nC, nh)).astype(
            np.float32))
        cin = torch.from_numpy(rng.standard_normal(
            (B, nC, nh, hd, ns)).astype(np.float32))
        got = tmamba._state_passing(L, cin)
        want = torch.zeros_like(cin)
        S = torch.zeros((B, nh, hd, ns))
        for c in range(nC):
            want[:, c] = S
            S = S * torch.exp(L[:, c])[..., None, None] + cin[:, c]
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_strong_decay_gives_finite_gradients():
    """Decays whose exp overflows above the diagonal (the reference's
    ``where(tri, exp(decay), 0)`` would take 0 * inf in its backward):
    the port masks before the exp, so every gradient is finite."""
    tcfg, jcfg = configs()
    _, tp = weights(jcfg)
    tp["A_log"] = torch.full_like(tp["A_log"], 3.0)       # A = -20
    tp["dt_bias"] = torch.full_like(tp["dt_bias"], 4.0)   # dt ~ 4
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(inputs(tcfg, S=32)).requires_grad_()
    out = tmamba.mamba_fwd(tcfg, leaves, xt)
    grads = torch.autograd.grad(out.square().sum(),
                                tree_leaves(leaves) + [xt])
    assert bool(torch.isfinite(out).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mamba_decode_matches_reference_and_forward():
    """Decode from a zero state, token by token: out and state against the
    reference's step (the port writes the state in place), and the outputs
    against the port's chunked forward."""
    tcfg, jcfg = configs()
    jp, tp = weights(jcfg, seed=4)
    B, S = 2, 21
    x = inputs(tcfg, B=B, S=S, seed=6)
    full = tmamba.mamba_fwd(tcfg, tp, torch.from_numpy(x))
    jst = jmamba.init_mamba_state(jcfg, B, jnp.float32)
    tst = tmamba.init_mamba_state(tcfg, B, torch.float32, device="cpu")
    ptrs = (tst.S.data_ptr(), tst.conv.data_ptr())
    for t in range(S):
        jo, jst = jmamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                      jst)
        to, tst2 = tmamba.mamba_decode(tcfg, tp, torch.from_numpy(
            x[:, t:t + 1]), tst)
        assert tst2 is tst and (tst.S.data_ptr(),
                                tst.conv.data_ptr()) == ptrs
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tst.S.numpy(), np.asarray(jst.S), **TOL)
        np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                                   **TOL)
        np.testing.assert_allclose(to[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {t}")


def test_state_axes_match_reference():
    tcfg, jcfg = configs()
    t = tmamba.init_mamba_state(tcfg, 3, torch.float32, device="cpu")
    j = jmamba.init_mamba_state(jcfg, 3, jnp.float32)
    assert tuple(t.S.shape) == j.S.shape and t.S.dtype == torch.float32
    assert tuple(t.conv.shape) == j.conv.shape
    assert tuple(tmamba.mamba_state_axes(t)) == tuple(
        jmamba.mamba_state_axes(j))
    stacked = tmamba.MambaState(*(a.expand((2, 4) + a.shape) for a in t))
    jstacked = jmamba.MambaState(*(jnp.broadcast_to(a, (2, 4) + a.shape)
                                   for a in j))
    assert tuple(tmamba.mamba_state_axes(stacked)) == tuple(
        jmamba.mamba_state_axes(jstacked))


def test_init_mamba_state_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, _ = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmamba.init_mamba_state(tcfg, 2, torch.float32)
    st = tmamba.init_mamba_state(tcfg, 2, torch.bfloat16, device="cpu")
    assert st.S.device.type == "cpu" and st.S.dtype == torch.float32
    assert st.conv.dtype == torch.bfloat16
