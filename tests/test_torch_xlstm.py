"""xLSTM (mLSTM + sLSTM blocks) against the reference, on the CPU.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`) and the same inputs (numpy, fixed seeds),
at the reference's reduced sizes (4 blocks: 2 groups of one mLSTM and
one sLSTM), in float32.  Tolerances: block outputs, logits and loss
within 1e-5 abs / 1e-4 rel, every gradient leaf within atol 1e-5 / rtol
1e-4 (XLA and torch sum in other orders); decode against the reference's
decode within 1e-4 / 1e-5 and against the port's own forward within
2e-3 (`tests/test_models_consistency.py`'s).  The sLSTM's post-MLP is the
tanh gelu (`jax.nn.gelu`'s default); one case shows the exact (erf) gelu
would miss the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-4, atol=1e-5)
#: The reference's reduced config, and one of 2 groups of 2 mLSTM + 1
#: sLSTM blocks.  In the second, the first mLSTM block of group 2 turns a
#: change of 1e-6 in its input into 4e-4 in its output (its normalizer
#: max(|sum_s w_ts q.k|, exp(-m)) comes near 0 for a few rows): float32
#: summation order alone then moves the logits past 1e-5, the port's and
#: the reference's each ~1e-4 from float64.  It is held to the reference
#: through float64 (`test_deeper_groups_against_float64`); the models'
#: other comparisons run the reference's reduced config.
OVERS = ({}, {"n_layers": 6, "slstm_every": 3})
IDS = ["reduced", "3-block-groups"]


def configs(**over):
    return (tconfigs.reduced(tconfigs.get_config(ARCH), **over),
            jconfigs.reduced(jconfigs.get_config(ARCH), **over))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shapes(tree):
    return dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tree))[0])


def weights(jcfg, seed=1):
    jparams, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(seed)))
    return jparams, params_from_numpy(to_numpy(jparams), "cpu")


def block_weights(init, jcfg, seed=0, scale=0.3):
    """One block's weights with every norm gain, bias and gamma random
    (the reference inits them to constants)."""
    jp, _ = jcommon.split_tree(init(jcfg, jcommon.Init(
        key=jax.random.key(seed))))
    rng = np.random.default_rng(seed + 50)
    jp = {k: (jnp.asarray(scale * rng.standard_normal(v.shape).astype(
        np.float32)) if v.ndim == 1 else v) for k, v in jp.items()}
    return jp, params_from_numpy(to_numpy(jp), "cpu")


def inputs(cfg, B=2, S=13, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def tokens(cfg, B=2, S=17, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (B, S)).astype(np.int32)


def test_config_and_dims_are_the_references():
    full = (tconfigs.get_config(ARCH), jconfigs.get_config(ARCH))
    for t, j in (full, configs()):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert tx._dims(t) == jx._dims(j)
        assert tx._groups(t) == jx._groups(j)
    t = full[0]
    assert tx._dims(t) == (1024, 2048, 4, 512) and t.head_dim == 256
    assert tx._groups(t) == (4, 5)


@pytest.mark.parametrize("over", OVERS, ids=IDS)
def test_init_tree_paths_shapes_and_axes(over):
    tcfg, jcfg = configs(**over)
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    assert shapes(tvals) == shapes(jvals)
    assert taxes == jaxes
    n_groups, km = tx._groups(tcfg)
    assert tvals["stack"]["mlstm"]["wq"].shape[:2] == (n_groups, km)
    assert torch.equal(tvals["stack"]["slstm"]["bf"],
                       torch.ones_like(tvals["stack"]["slstm"]["bf"]))
    assert torch.equal(tvals["stack"]["mlstm"]["bf"],
                       torch.ones_like(tvals["stack"]["mlstm"]["bf"]))


@pytest.mark.parametrize("S", [13, 1])
def test_mlstm_fwd_matches_reference(S):
    tcfg, jcfg = configs()
    jp, tp = block_weights(jx.init_mlstm, jcfg)
    x = inputs(tcfg, S=S)
    want = jx.mlstm_fwd(jcfg, jp, jnp.asarray(x))
    got = tx.mlstm_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [13, 1])
def test_slstm_fwd_matches_reference(S):
    tcfg, jcfg = configs()
    jp, tp = block_weights(jx.init_slstm, jcfg)
    x = inputs(tcfg, S=S)
    want = jx.slstm_fwd(jcfg, jp, jnp.asarray(x))
    got = tx.slstm_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_slstm_gelu_is_the_tanh_form():
    """The tanh and erf gelus differ by up to 4.7e-4 near |x| = 2.3: with
    the post-MLP's pre-activations there, the port (tanh) holds the
    reference within the tolerance, and the same block with the exact gelu
    does not."""
    tcfg, jcfg = configs()
    jp, tp = block_weights(jx.init_slstm, jcfg, seed=3, scale=1.0)
    tp["up"] = tp["up"] * 3.0
    jp = dict(jp, up=jnp.asarray(tp["up"].numpy()))
    x = inputs(tcfg, S=7, seed=4)
    want = np.asarray(jx.slstm_fwd(jcfg, jp, jnp.asarray(x)))
    got = tx.slstm_fwd(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    gelu = torch.nn.functional.gelu

    def erf_gelu(t, approximate="none"):
        return gelu(t)                 # the exact form, whatever is asked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "gelu", erf_gelu)
        wrong = tx.slstm_fwd(tcfg, tp, torch.from_numpy(x)).numpy()
    assert not np.allclose(wrong, want, **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_gradients_match_reference(block):
    tcfg, jcfg = configs()
    init, fwd = {"mlstm": (jx.init_mlstm, "mlstm_fwd"),
                 "slstm": (jx.init_slstm, "slstm_fwd")}[block]
    jp, tp = block_weights(init, jcfg, seed=5)
    x = inputs(tcfg, S=11, seed=6)
    wout = np.random.default_rng(7).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(getattr(jx, fwd)(jcfg, p, xx) * wout)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    loss = (getattr(tx, fwd)(tcfg, leaves, xt) * torch.from_numpy(
        wout)).sum()
    grads = torch.autograd.grad(loss, tree_leaves(leaves) + [xt])
    ref = jax.tree_util.tree_leaves(jg) + [jgx]
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_decode_matches_reference_and_forward(block):
    """Token by token from a zero state: out and state against the
    reference's step (the port writes the state in place), and the outputs
    against the port's parallel (mLSTM) or scanned (sLSTM) forward."""
    tcfg, jcfg = configs()
    init = {"mlstm": jx.init_mlstm, "slstm": jx.init_slstm}[block]
    jp, tp = block_weights(init, jcfg, seed=8)
    B, S = 2, 15
    x = inputs(tcfg, B=B, S=S, seed=9)
    full = getattr(tx, f"{block}_fwd")(tcfg, tp, torch.from_numpy(x))
    jst = getattr(jx, f"init_{block}_state")(jcfg, B, jnp.float32)
    tst = getattr(tx, f"init_{block}_state")(tcfg, B, torch.float32,
                                             device="cpu")
    ptrs = [t.data_ptr() for t in tst]
    jdec, tdec = getattr(jx, f"{block}_decode"), getattr(tx,
                                                         f"{block}_decode")
    for t in range(S):
        jo, jst = jdec(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        to, tst2 = tdec(tcfg, tp, torch.from_numpy(x[:, t:t + 1]), tst)
        assert tst2 is tst and [a.data_ptr() for a in tst] == ptrs
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        np.testing.assert_allclose(to[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {t}")


@pytest.mark.parametrize("over", OVERS[:1], ids=IDS[:1])
def test_lm_logits_match_reference(over):
    tcfg, jcfg = configs(**over)
    jparams, tparams = weights(jcfg)
    toks = tokens(tcfg, S=21)
    want, _, _ = jget_model(jcfg).logits(jparams, {"tokens": jnp.asarray(
        toks)}, activ_dtype=jnp.float32)
    got, H, aux = get_model(tcfg).logits(tparams, {"tokens": torch.from_numpy(
        toks)}, activ_dtype=torch.float32)
    assert H is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last, _, _ = get_model(tcfg).logits(tparams, {"tokens": torch.from_numpy(
        toks)}, activ_dtype=torch.float32, last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:], **TOL)


@pytest.mark.parametrize("over", OVERS[:1], ids=IDS[:1])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_gradients_match_reference(over, remat):
    tcfg, jcfg = configs(**over)
    jparams, tparams = weights(jcfg)
    toks = tokens(tcfg)

    def jloss(p):
        return jget_model(jcfg).loss(p, {"tokens": jnp.asarray(toks)},
                                     activ_dtype=jnp.float32, remat=remat)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss, (H, _) = get_model(tcfg).loss(
        leaves, {"tokens": torch.from_numpy(toks)},
        activ_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert H is None


def test_deeper_groups_against_float64():
    """The 2 x (2 mLSTM + 1 sLSTM) stack: the port's float32 logits and
    the reference's both near the port's float64 logits (the reference
    within 1e-2, so the float64 run is the reference's function too), the
    port no further than twice the reference's distance plus 1e-5."""
    tcfg, jcfg = configs(**OVERS[1])
    jparams, tparams = weights(jcfg)
    toks = tokens(tcfg, S=21)
    want, _, _ = jget_model(jcfg).logits(jparams, {"tokens": jnp.asarray(
        toks)}, activ_dtype=jnp.float32)
    api = get_model(tcfg)
    got, _, _ = api.logits(tparams, {"tokens": torch.from_numpy(toks)},
                           activ_dtype=torch.float32)
    exact, _, _ = api.logits(tree_map(lambda t: t.double(), tparams),
                             {"tokens": torch.from_numpy(toks)},
                             activ_dtype=torch.float64)
    exact = exact.numpy()
    ref_err = np.abs(np.asarray(want, np.float64) - exact).max()
    port_err = np.abs(got.numpy().astype(np.float64) - exact).max()
    assert ref_err < 1e-2
    assert port_err <= 2 * ref_err + 1e-5, (port_err, ref_err)


def cache_to_jax(c):
    """The port's XLSTMCache as the reference's pytree of numpy arrays."""
    return jx.XLSTMCache(mlstm=jx.MLSTMState(*(t.numpy() for t in c.mlstm)),
                         slstm=jx.SLSTMState(*(t.numpy() for t in c.slstm)))


@pytest.mark.parametrize("over", OVERS[:1], ids=IDS[:1])
def test_decode_matches_reference_and_forward(over):
    """The port's counterpart of `test_decode_matches_forward[xlstm-350m]`:
    20 steps against the reference's decode (1e-4 / 1e-5, the states too)
    and the port's own forward (2e-3); the caches are updated in place."""
    tcfg, jcfg = configs(**over)
    jparams, tparams = weights(jcfg, seed=0)
    B, S = 2, 20
    toks = tokens(tcfg, B=B, S=S, seed=3)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    full, _, _ = tapi.logits(tparams, {"tokens": torch.from_numpy(toks)},
                             activ_dtype=torch.float32)
    jc = japi.init_decode(B, S + 2, jnp.float32)
    tc = tapi.init_decode(B, S + 2, torch.float32, device="cpu")
    ptrs = [t.data_ptr() for t in tc.mlstm + tc.slstm]
    jstep = jax.jit(lambda p, c, t: japi.decode_step(
        p, c, {"tokens": t}, activ_dtype=jnp.float32))
    for t in range(S):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]))
        tl, tc2 = tapi.decode_step(tparams, tc, {"tokens": torch.from_numpy(
            toks[:, t]).long()}, activ_dtype=torch.float32)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=f"step {t}")
    assert [t.data_ptr() for t in tc.mlstm + tc.slstm] == ptrs
    for a, b in zip(jax.tree_util.tree_leaves(cache_to_jax(tc)),
                    jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("over", OVERS, ids=IDS)
def test_cache_trees_and_axes_match_reference(over):
    tcfg, jcfg = configs(**over)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jc = japi.init_decode(3, 12, jnp.bfloat16)
    tc = tapi.init_decode(3, 12, torch.bfloat16, device="cpu")
    assert shapes(cache_to_jax(tc)) == shapes(jc)
    for a, b in zip(jax.tree_util.tree_leaves(cache_to_jax(tc)),
                    jax.tree_util.tree_leaves(jc)):
        assert a.dtype == np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    jaxes, taxes = japi.cache_axes(jc), tapi.cache_axes(tc)
    assert tuple(taxes.mlstm) == tuple(jaxes.mlstm)
    assert tuple(taxes.slstm) == tuple(jaxes.slstm)
    one = tx.cache_axes(tx.XLSTMCache(
        mlstm=tx.init_mlstm_state(tcfg, 2, device="cpu"),
        slstm=tx.init_slstm_state(tcfg, 2, device="cpu")))
    jone = jx.cache_axes(jx.XLSTMCache(
        mlstm=jx.init_mlstm_state(jcfg, 2, jnp.float32),
        slstm=jx.init_slstm_state(jcfg, 2, jnp.float32)))
    assert tuple(one.mlstm) == tuple(jone.mlstm)
    assert tuple(one.slstm) == tuple(jone.slstm)


def test_stacked_states_are_views():
    tcfg, _ = configs(**OVERS[1])
    c = get_model(tcfg).init_decode(1, 4, torch.float32, device="cpu")
    n_groups, km = tx._groups(tcfg)
    st = ttfm.unstack(ttfm.unstack(c.mlstm, n_groups)[1], km)[1]
    st.C.fill_(3.0)
    ttfm.unstack(c.slstm, n_groups)[1].m.fill_(-1.0)
    assert float(c.mlstm.C[1, 1].min()) == 3.0
    assert float(c.mlstm.C[1, 0].abs().max()) == 0.0
    assert float(c.slstm.m[1].max()) == -1.0
    assert float(c.slstm.m[0].abs().max()) == 0.0


def test_states_and_caches_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, _ = configs()
    for make in (lambda **kw: tx.init_mlstm_state(tcfg, 2, torch.float32,
                                                  **kw),
                 lambda **kw: tx.init_slstm_state(tcfg, 2, torch.float32,
                                                  **kw),
                 lambda **kw: tx.init_decode_caches(tcfg, 2, 8, torch.float32,
                                                    **kw),
                 lambda **kw: get_model(tcfg).init_decode(2, 8,
                                                          torch.float32,
                                                          **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        leaves = make(device="cpu")
        leaves = leaves.mlstm + leaves.slstm if hasattr(leaves, "mlstm") \
            else leaves
        assert all(t.device.type == "cpu" for t in leaves)


def test_runs_through_the_step_builders_and_launchers(capsys):
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime.step import make_prefill_step
    tcfg, jcfg = configs()
    _, tparams = weights(jcfg)
    toks = torch.from_numpy(tokens(tcfg, S=19))
    step = make_prefill_step(RunConfig(tcfg, SHAPES["prefill_32k"],
                                       activ_dtype="float32"))
    last = step(tparams, {"tokens": toks}, None)
    full, _, _ = get_model(tcfg).logits(tparams, {"tokens": toks},
                                        activ_dtype=torch.float32)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(), **TOL)
    losses = ttrain.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                          "--steps", "4", "--batch", "2", "--seq", "16",
                          "--log-every", "1"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    finished = tserve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "3", "--slots", "2", "--max-new", "4"])
    assert sorted(finished) == [0, 1, 2]
    assert all(len(r.out) == 4 for r in finished.values())
    assert "served 3 requests" in capsys.readouterr().out


def test_init_draws_ones_where_the_reference_does():
    """`Init.param(kind="ones")` (the forget-gate biases, Mamba's Dskip)
    gives ones, in the stacked prefix too."""
    ini = tcommon.Init(gen=torch.Generator().manual_seed(0)).stacked(2, 3)
    a = ini.param((5,), ("ssm_heads",), kind="ones")
    assert a.axes == ("layers", "layers", "ssm_heads")
    assert torch.equal(a.value, torch.ones((2, 3, 5)))
