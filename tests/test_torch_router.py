"""The port's backpressure MoE router against the reference, on the CPU.

`route` over 10 steps in each mode, from the same logits (numpy, fixed
seeds): the same experts, and H and load within 1e-5 (softmax sums in
another order in XLA and torch, so float state agrees to rounding).  Then
the five behaviours of `tests/test_router.py` on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import router as jrouter  # noqa: E402
from repro_torch.core.router import (RouterConfig, init_router_state,  # noqa: E402
                                     load_violation, route, topk_first)


def skewed_logits(rng, T, E, hot=0, strength=3.0):
    logits = (rng.standard_normal((T, E)) * 0.5).astype(np.float32)
    logits[:, hot] += strength
    return logits


@pytest.mark.parametrize("mode,beta", [("plain", 0.0), ("aux", 0.0),
                                       ("backpressure", 2.0)])
@pytest.mark.parametrize("T,E,k", [(96, 16, 2), (64, 8, 3)])
def test_route_matches_jax_over_10_steps(mode, beta, T, E, k):
    rng = np.random.default_rng(T + E)
    kw = dict(n_experts=E, k=k, mode=mode, beta=beta)
    tcfg, jcfg = RouterConfig(**kw), jrouter.RouterConfig(**kw)
    ts, js = init_router_state(E, "cpu"), jrouter.init_router_state(E)
    for _ in range(10):
        logits = skewed_logits(rng, T, E)
        tout = route(tcfg, ts, torch.from_numpy(logits))
        jout = jrouter.route(jcfg, js, jnp.asarray(logits))
        np.testing.assert_array_equal(tout.expert_idx.numpy(),
                                      np.asarray(jout.expert_idx))
        np.testing.assert_allclose(tout.new_state.H.numpy(),
                                   np.asarray(jout.new_state.H), atol=1e-5)
        np.testing.assert_allclose(tout.load.numpy(), np.asarray(jout.load),
                                   atol=1e-5)
        np.testing.assert_allclose(tout.combine_w.numpy(),
                                   np.asarray(jout.combine_w), atol=1e-5)
        np.testing.assert_allclose(float(tout.aux_loss),
                                   float(jout.aux_loss), atol=1e-5)
        assert int(tout.new_state.steps) == int(jout.new_state.steps)
        ts, js = tout.new_state, jout.new_state


def test_topk_first_takes_lowest_index_on_ties():
    x = torch.tensor([[1.0, 2.0, 2.0, 2.0], [0.0, 0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(topk_first(x, 2).numpy(), [[1, 2], [0, 1]])
    np.testing.assert_array_equal(
        topk_first(x, 2).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 2)[1]))


# ---- the behaviours of tests/test_router.py, on the port -----------------

def test_plain_router_collapses_backpressure_balances():
    rng = np.random.default_rng(0)
    E, T, k = 16, 512, 2
    cfg_bp = RouterConfig(n_experts=E, k=k, mode="backpressure", beta=2.0)
    cfg_pl = RouterConfig(n_experts=E, k=k, mode="plain")
    state_bp, state_pl = (init_router_state(E, "cpu"),
                          init_router_state(E, "cpu"))
    loads_bp, loads_pl = [], []
    for _ in range(30):
        logits = torch.from_numpy(skewed_logits(rng, T, E))
        out_bp = route(cfg_bp, state_bp, logits)
        out_pl = route(cfg_pl, state_pl, logits)
        state_bp, state_pl = out_bp.new_state, out_pl.new_state
        loads_bp.append(out_bp.load)
        loads_pl.append(out_pl.load)
    v_bp = float(load_violation(torch.stack(loads_bp[-10:]).mean(0)))
    v_pl = float(load_violation(torch.stack(loads_pl[-10:]).mean(0)))
    assert v_pl > 3.0          # plain top-k slams the hot expert
    assert v_bp < 1.6          # backpressure bias spreads the load
    assert v_bp < v_pl / 2


def test_h_queue_update_rule():
    # H_e <- [H_e + assigned_e - capacity]^+  (paper eq. for H_n).
    E, T, k = 4, 8, 1
    cfg = RouterConfig(n_experts=E, k=k, mode="backpressure", beta=0.0)
    logits = torch.full((T, E), -10.0)
    logits[:, 2] = 10.0                                  # all to expert 2
    out = route(cfg, init_router_state(E, "cpu"), logits)
    expected = np.zeros(E)
    expected[2] = T - T * k / E
    np.testing.assert_allclose(out.new_state.H.numpy(), expected, atol=1e-5)


def test_combine_weights_normalized_and_from_gates():
    cfg = RouterConfig(n_experts=8, k=3, mode="backpressure", beta=1.0)
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((32, 8)).astype(np.float32))
    out = route(cfg, init_router_state(8, "cpu"), logits)
    np.testing.assert_allclose(out.combine_w.sum(1).numpy(), 1.0, atol=1e-5)
    assert (out.combine_w >= 0).all()


def test_aux_mode_has_differentiable_loss():
    cfg = RouterConfig(n_experts=8, k=2, mode="aux", aux_coef=0.01)
    logits = (torch.ones((16, 8)) * 0.1).requires_grad_(True)
    (g,) = torch.autograd.grad(route(cfg, init_router_state(8, "cpu"),
                                     logits).aux_loss, logits)
    assert torch.isfinite(g).all()


def test_bias_affects_selection_not_weights():
    # With a huge H on the favourite expert, selection avoids it, and
    # combine weights are still the renormalized raw gates of the selected.
    E, k = 4, 1
    cfg = RouterConfig(n_experts=E, k=k, mode="backpressure", beta=100.0)
    state = init_router_state(E, "cpu")._replace(
        H=torch.tensor([0.0, 0.0, 1e6, 0.0]))
    logits = torch.tensor([[0.0, 1.0, 5.0, 0.5]]).repeat(10, 1)
    out = route(cfg, state, logits)
    assert not (out.expert_idx == 2).any()
    np.testing.assert_allclose(out.combine_w.numpy(), 1.0, atol=1e-6)
