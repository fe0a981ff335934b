"""The zamba hybrid (Mamba2 backbone + one shared attention block) against
the reference, on the CPU.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`) and the same tokens (numpy, fixed seeds),
at the reference's reduced sizes (4 mamba layers in 2 groups, the shared
block twice), in float32.  Tolerances: logits and loss within 1e-5 abs /
1e-4 rel, every gradient leaf within atol 1e-5 / rtol 1e-4 (XLA and torch
sum in other orders); decode against the reference's decode within 1e-4 /
1e-5 and against the port's own forward within 2e-3
(`tests/test_models_consistency.py`'s).  The launchers run the family on
the CPU through their normal entry points.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.models import zamba as jzamba  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import zamba as tzamba  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCH = "zamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-5)
#: The reference's reduced config, and one whose groups hold 3 layers and
#: whose chunk (8) splits a sequence into several chunks.
OVERS = ({}, {"n_layers": 6, "attn_every": 3, "ssm_chunk": 8})
IDS = ["reduced", "3-layer-groups"]


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


def tokens(cfg, B=2, S=17, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (B, S)).astype(np.int32)


def test_config_is_the_references():
    full = (tconfigs.get_config(ARCH), jconfigs.get_config(ARCH))
    for t, j in (full, configs()):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    t = full[0]
    assert (t.family, t.n_layers, t.attn_every, t.head_dim) == \
        ("hybrid", 54, 6, 80)
    assert tzamba._groups(t) == jzamba._groups(full[1]) == (9, 6)


@pytest.mark.parametrize("over", OVERS, ids=IDS)
def test_init_tree_paths_shapes_and_axes(over):
    tcfg, jcfg = configs(**over)
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    assert shapes(tvals) == shapes(jvals)
    assert taxes == jaxes
    n_groups, k = tzamba._groups(tcfg)
    assert tvals["stack"]["mamba"]["m"]["wz"].shape[:2] == (n_groups, k)
    assert tvals["stack"]["shared"]["attn"]["wq"].dim() == 3   # one block


@pytest.mark.parametrize("over", OVERS, ids=IDS)
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


@pytest.mark.parametrize("over", OVERS, ids=IDS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_gradients_match_reference(over, remat):
    """The shared block's gradient sums over its applications, as the
    reference's does."""
    tcfg, jcfg = configs(**over)
    jparams, tparams = weights(jcfg)
    toks = tokens(tcfg)

    def jloss(p):
        return jget_model(jcfg).loss(p, {"tokens": jnp.asarray(toks)},
                                     activ_dtype=jnp.float32, remat=remat)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss, (H, metrics) = get_model(tcfg).loss(
        leaves, {"tokens": torch.from_numpy(toks)},
        activ_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jl),
                               rtol=1e-5)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert H is None


def cache_to_jax(c):
    """The port's ZambaCache as the reference's pytree of numpy arrays."""
    from repro.models.attention import KVCache as JKVCache
    from repro.models.mamba import MambaState as JMambaState
    return jzamba.ZambaCache(ssm=JMambaState(*(t.numpy() for t in c.ssm)),
                             attn=JKVCache(*(t.numpy() for t in c.attn)))


@pytest.mark.parametrize("over", OVERS, ids=IDS)
def test_decode_matches_reference_and_forward(over):
    """The port's counterpart of `test_decode_matches_forward[zamba2-2.7b]`:
    20 steps against the reference's decode (1e-4 / 1e-5, the caches too)
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
    ptrs = [t.data_ptr() for t in tc.ssm + tc.attn]
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
    assert [t.data_ptr() for t in tc.ssm + tc.attn] == ptrs
    flat_t = jax.tree_util.tree_leaves(cache_to_jax(tc))
    flat_j = jax.tree_util.tree_leaves(jc)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("over", OVERS, ids=IDS)
def test_cache_trees_and_axes_match_reference(over):
    tcfg, jcfg = configs(**over)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jc = japi.init_decode(3, 12, jnp.float32)
    tc = tapi.init_decode(3, 12, torch.float32, device="cpu")
    assert shapes(cache_to_jax(tc)) == shapes(jc)
    for a, b in zip(jax.tree_util.tree_leaves(cache_to_jax(tc)),
                    jax.tree_util.tree_leaves(jc)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    # the SSM state is float32 whatever the activations; the conv tail and
    # the KV cache take the activations' dtype
    jb = japi.init_decode(3, 12, jnp.bfloat16)
    tb = tapi.init_decode(3, 12, torch.bfloat16, device="cpu")
    assert [str(t.dtype).split(".")[-1] for t in tb.ssm + tb.attn] == \
        [str(t.dtype) for t in jb.ssm + jb.attn]
    jaxes, taxes = japi.cache_axes(jc), tapi.cache_axes(tc)
    assert tuple(taxes.ssm) == tuple(jaxes.ssm)
    assert tuple(taxes.attn) == tuple(jaxes.attn)


def test_stacked_states_are_views():
    """A write through one layer's state (two `unbind`s deep) reaches the
    stacked cache, and no other layer's."""
    tcfg, _ = configs(**OVERS[1])
    c = get_model(tcfg).init_decode(1, 4, torch.float32, device="cpu")
    n_groups, k = tzamba._groups(tcfg)
    st = ttfm.unstack(ttfm.unstack(c.ssm, n_groups)[1], k)[2]
    st.S.fill_(2.0)
    st.conv.add_(1.0)
    assert float(c.ssm.S[1, 2].min()) == 2.0
    assert float(c.ssm.conv[1, 2].min()) == 1.0
    assert float(c.ssm.S[1, 1].abs().max()) == 0.0
    assert float(c.ssm.S[0, 2].abs().max()) == 0.0


def test_decode_caches_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg, _ = configs()
    api = get_model(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_decode(2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzamba.init_decode_caches(tcfg, 2, 8, torch.float32)
    c = api.init_decode(2, 8, torch.float32, device="cpu")
    assert c.ssm.S.device.type == c.attn.k.device.type == "cpu"
    assert api.init_state(device="cpu").router_H is None


def test_runs_through_the_step_builders_and_launchers(capsys):
    """`make_prefill_step`, `launch.train.main` and `launch.serve.main`
    drive the family on the CPU with no family branch of their own."""
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
