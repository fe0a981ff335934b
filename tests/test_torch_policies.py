"""Parity of the port's batched `slot_step` with the JAX reference.

Each case pads a registered scenario, knocks out comp nodes, starts from a
random queue state made with numpy, and steps both packages 1 and 8 slots
with the same arrivals and the same regulator draws (the JAX package's
`bernoulli(key, eps, (NC,))` bits fed through the port's noise seam).
Decisions must be equal; the state must agree within rtol 1e-6 after one
slot and 1e-5 after eight (reductions sum in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.policies import PolicyConfig as JConfig  # noqa: E402
from repro.core.policies import slot_step as jstep  # noqa: E402
from repro.core.queues import NetState as JState  # noqa: E402
from repro.fleet import PadDims as JDims  # noqa: E402
from repro.fleet import get_scenario as jscenario  # noqa: E402
from repro.fleet import pad_problem as jpad  # noqa: E402
from repro_torch.convert import (STATE_FIELDS, net_state_from_numpy,  # noqa: E402
                                 net_state_to_numpy,
                                 padded_problem_from_numpy)
from repro_torch.core.graph import ComputeProblem, Graph  # noqa: E402
from repro_torch.core.policies import PolicyConfig, slot_step  # noqa: E402
from repro_torch.fleet.batching import LEAVES  # noqa: E402
from test_torch_bp_slot import CASES, random_state  # noqa: E402


def run_both(jp, cfg_kw, state0, arrivals, seed, eps_b=0.05):
    """Step the reference and the port from the same state, slot by slot;
    yields per slot the (n_star, computed) decisions and the states of
    both, as numpy."""
    tp = padded_problem_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in LEAVES}, jp.n_nodes,
        jp.n_comp, "cpu")
    jcfg = JConfig(**cfg_kw)
    tcfg = PolicyConfig(**cfg_kw)
    js = JState(**{k: jnp.asarray(v) for k, v in state0.items()})
    ts = net_state_from_numpy(state0, "cpu")
    key = jax.random.key(seed)
    jrun = jax.jit(lambda s, a, k: jstep(jp, jcfg, s, a, k,
                                         eps_b=jnp.float32(eps_b)))
    for t, arr in enumerate(arrivals):
        kt = jax.random.fold_in(key, t)
        draws = np.asarray(jax.random.bernoulli(kt, eps_b, (jp.n_comp,)),
                           np.float32)
        js, jm = jrun(js, jnp.float32(arr), kt)
        ts, tm = slot_step(tp, tcfg, ts, torch.tensor([arr]),
                           torch.from_numpy(draws)[None],
                           torch.tensor([eps_b]))
        yield ((int(jm["n_star"]), float(jm["computed"])),
               (int(tm["n_star"][0]), float(tm["computed"][0])),
               {k: np.asarray(getattr(js, k)) for k in STATE_FIELDS},
               {k: v[0] for k, v in net_state_to_numpy(ts).items()})


def assert_close(jst, tst, rtol):
    for k in STATE_FIELDS:
        np.testing.assert_allclose(tst[k], jst[k], rtol=rtol, atol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("scen,policy,pad_extra,fail,pairing", CASES)
def test_slot_step_matches_reference(scen, policy, pad_extra, fail, pairing):
    """Equal decisions every slot; state within rtol 1e-6 after slot 1 and
    1e-5 after slot 8."""
    problem = jscenario(scen).build(0)
    dims = JDims(problem.graph.n_nodes + pad_extra,
                 problem.graph.n_edges + 2 * pad_extra,
                 problem.n_comp + pad_extra)
    jp = jpad(problem, dims)
    comp_scale = jnp.array(
        [0.0 if (fail >> (i % 3)) & 1 and i > 0 else 1.0
         for i in range(dims.n_comp)], jnp.float32)
    jp = jp.with_capacity_scales(jnp.ones(jp.n_edges), comp_scale)
    rng = np.random.default_rng(len(scen) * 7 + pad_extra)
    state0 = random_state(rng, dims.n_nodes, dims.n_comp)
    arrivals = (rng.random(8) * 4).astype(np.float32)
    cfg = dict(name=policy, eps_b=0.05, pairing=pairing, threshold=1.5,
               wireless=jscenario(scen).wireless)
    for t, (jdec, tdec, jst, tst) in enumerate(
            run_both(jp, cfg, state0, arrivals, seed=len(scen))):
        rtol = 1e-6 if t == 0 else 1e-5
        assert tdec[0] == jdec[0], f"n_star differs at slot {t}"
        np.testing.assert_allclose(tdec[1], jdec[1], rtol=rtol, atol=rtol)
        if t in (0, 7):
            assert_close(jst, tst, rtol)


def test_scatter_collision_two_edges_one_queue():
    """Two edges leave node 0 with the same class (node 0 holds raw s1
    packets, both neighbours are empty): their outflows collide in one
    (node, class) entry, are capped at its content, and the port's
    deterministic scatter matches the reference."""
    g = Graph(4, np.array([(0, 1), (0, 2), (1, 3), (2, 3)], np.int32),
              np.full(4, 5.0))
    problem = ComputeProblem(g, s1=0, s2=1, dest=2, comp_nodes=(3,),
                             comp_caps=(2.0,))
    jp = jpad(problem, JDims(4, 5, 1))
    state0 = random_state(np.random.default_rng(0), 4, 1)
    for k in state0:
        state0[k] = np.zeros_like(state0[k])
    state0["Q"][0, 1, 0] = 3.0          # both (0,1) and (0,2) pick it
    _, _, jst, tst = next(run_both(jp, dict(name="pi3bar"), state0,
                                   np.zeros(1, np.float32), seed=0))
    assert_close(jst, tst, 1e-7)
    # 3 packets split over two 5-capacity links: all leave, none is made
    assert tst["Q"][0, 1, 0] == 0.0
    assert tst["Q"][1, 1, 0] + tst["Q"][2, 1, 0] == pytest.approx(3.0)


def test_convert_and_router_state_default_to_cuda(monkeypatch):
    """The numpy converters, the padded-problem builders and
    `init_router_state` resolve their device like every other entry point:
    CUDA unless asked, raising without a card."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.router import init_router_state
    from repro_torch.fleet import (PadDims, get_scenario, pad_problem,
                                   stack_problems)
    from repro_torch.fleet.batching import from_leaves, pad_leaves
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = jscenario("paper_grid").build(0)
    jp = jpad(problem, JDims.of([problem]))
    leaves = {k: np.asarray(getattr(jp, k)) for k in LEAVES}
    state0 = random_state(np.random.default_rng(0), jp.n_nodes, jp.n_comp)
    params = {"w": np.ones((2, 3), np.float32), "sub": {"b": np.zeros(3)}}
    calls = {
        "padded_problem_from_numpy": lambda **kw: padded_problem_from_numpy(
            leaves, jp.n_nodes, jp.n_comp, **kw).edges,
        "net_state_from_numpy": lambda **kw: net_state_from_numpy(
            state0, **kw).Q,
        "params_from_numpy": lambda **kw: params_from_numpy(
            params, **kw)["sub"]["b"],
        "init_router_state": lambda **kw: init_router_state(8, **kw).H,
    }
    tproblems = [get_scenario(name).build(0)
                 for name in ("paper_grid", "ring")]
    dims = PadDims.of(tproblems)
    calls.update({
        "from_leaves": lambda **kw: from_leaves(
            [pad_leaves(p, dims) for p in tproblems], dims.n_nodes,
            dims.n_comp, **kw).edges,
        "pad_problem": lambda **kw: pad_problem(
            tproblems[0], dims, **kw).sink,
        "stack_problems": lambda **kw: stack_problems(
            tproblems, dims, **kw).comp_caps,
    })
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu").device.type == "cpu", name


def test_arrivals_and_model_state_default_to_cuda(monkeypatch):
    """The twin of the test above for the three entry points that built
    their tensors on the CPU when given no device: `sim.poisson_arrivals`
    and `models.transformer`'s `init_model_state` and
    `init_decode_caches` resolve their device as every other entry point
    does, CUDA unless asked, raising without a card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer
    from repro_torch.sim import poisson_arrivals
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    calls = {
        "poisson_arrivals": lambda **kw: poisson_arrivals([2.0, 5.0], 16,
                                                          seed=3, **kw),
        "init_model_state": lambda **kw: transformer.init_model_state(
            cfg, **kw).router_H,
        "init_decode_caches": lambda **kw: transformer.init_decode_caches(
            cfg, 2, 8, torch.float32, **kw)["layers"].k,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu").device.type == "cpu", name


def test_init_cache_defaults_to_cuda(monkeypatch):
    """`models.attention.init_cache`, called directly, resolves its device
    as every other entry point does: CUDA unless asked, raising without a
    card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.attention import init_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 8, torch.float32)
    cache = init_cache(cfg, 2, 8, torch.float32, device="cpu")
    assert all(x.device.type == "cpu" for x in cache)
