"""The rest of the dense family against the reference, on the CPU:
gemma3-27b's k-local:1-global stack and qwen1.5-32b, reduced.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`) and the same tokens (numpy, fixed seeds),
in float32.  Tolerances: logits and loss within 1e-5 abs / 1e-4 rel,
every gradient leaf within atol 1e-5 / rtol 1e-4 (XLA and torch sum in
other orders); decode against the forward within 2e-3
(`tests/test_models_consistency.py`'s), against the reference's decode
within 1e-4 / 1e-5.  gemma3 runs at the reference's reduced 6 layers (one
5:1 group) and at 8 (a tail of 2), window 8, so a 20-step decode wraps
every local ring.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import paper_grid as jpaper_grid  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import paper_grid as tpaper_grid  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

NEW_ARCHS = ("gemma3-27b", "qwen1.5-32b", "internvl2-1b",
             "seamless-m4t-large-v2")
#: (arch, overrides): gemma3 at 6 layers and at 8 (tail 2), qwen1.5.
MODELS = (("gemma3-27b", {}), ("gemma3-27b", {"n_layers": 8}),
          ("qwen1.5-32b", {}))
IDS = ["gemma3-6", "gemma3-8", "qwen1.5"]
TOL = dict(rtol=1e-4, atol=1e-5)


def configs(arch, **over):
    return (tconfigs.reduced(tconfigs.get_config(arch), **over),
            jconfigs.reduced(jconfigs.get_config(arch), **over))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shapes(tree):
    return dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tree))[0])


def weights(jcfg, seed=1):
    jparams, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(seed)))
    return jparams, params_from_numpy(to_numpy(jparams), "cpu")


# ---------------------------------------------------------------------------
# Configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_are_the_references(arch):
    full = (tconfigs.get_config(arch), jconfigs.get_config(arch))
    for t, j in (full, configs(arch)):
        jd = dataclasses.asdict(j)
        assert dataclasses.asdict(t) == {k: jd[k] for k in
                                         dataclasses.asdict(t)}
        assert dataclasses.asdict(t).keys() == jd.keys()


@pytest.mark.parametrize("C", [2.0, 3.0])
def test_paper_grid_problem_is_the_references(C):
    t, j = tpaper_grid.problem(C), jpaper_grid.problem(C)
    assert (t.s1, t.s2, t.dest, t.comp_nodes, t.comp_caps) == \
        (j.s1, j.s2, j.dest, j.comp_nodes, j.comp_caps)
    assert t.graph.n_nodes == j.graph.n_nodes
    np.testing.assert_array_equal(t.graph.edges, np.asarray(j.graph.edges))
    np.testing.assert_array_equal(t.graph.capacity,
                                  np.asarray(j.graph.capacity))


@pytest.mark.parametrize("arch,over", MODELS, ids=IDS)
def test_init_tree_paths_shapes_and_axes(arch, over):
    tcfg, jcfg = configs(arch, **over)
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    assert shapes(tvals) == shapes(jvals)
    assert taxes == jaxes
    if tcfg.local_global:
        n_groups, k, tail = ttfm._pattern(tcfg)
        assert (n_groups, k, tail) == jtfm._pattern(jcfg)
        assert sorted(tvals["stack"]) == (["global", "local", "tail"]
                                          if tail else ["global", "local"])
        assert tvals["stack"]["local"]["attn"]["wq"].shape[:2] == (n_groups,
                                                                   k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_param_draws_are_the_out_of_place_draws(dtype):
    """`Init.param` scales its float32 draw in place; every value must be
    the one ``(v * scale).to(dtype)`` gave, bit for bit."""
    tcfg, _ = configs("gemma3-27b", n_layers=8)
    got, _ = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(3), dtype=dtype))
    gen = torch.Generator().manual_seed(3)

    def old_param(self, shape, axes, scale=None, kind="normal"):
        shape = tuple(int(s) for s in shape)
        if scale is None:
            scale = 1.0 / np.sqrt(max(shape[0] if shape else 1, 1))
        full = tuple(self.prefix) + shape
        axes = ("layers",) * len(self.prefix) + tuple(axes)
        if kind == "zeros":
            return tcommon.Annotated(torch.zeros(full, dtype=self.dtype),
                                     axes)
        v = torch.empty(full, dtype=torch.float32)
        torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.gen)
        return tcommon.Annotated((v * scale).to(self.dtype), axes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcommon.Init, "param", old_param)
        want, _ = split_tree(get_model(tcfg).init(gen, dtype=dtype))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Forward, loss and gradients
# ---------------------------------------------------------------------------

def tokens(cfg, B=2, S=17, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch,over", MODELS, ids=IDS)
def test_lm_logits_match_reference(arch, over):
    tcfg, jcfg = configs(arch, **over)
    jparams, tparams = weights(jcfg)
    toks = tokens(tcfg, S=21)
    want, _, _ = jget_model(jcfg).logits(jparams, {"tokens": jnp.asarray(
        toks)}, activ_dtype=jnp.float32)
    got, H, _ = get_model(tcfg).logits(tparams, {"tokens": torch.from_numpy(
        toks)}, activ_dtype=torch.float32)
    assert H is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last, _, _ = get_model(tcfg).logits(tparams, {"tokens": torch.from_numpy(
        toks)}, activ_dtype=torch.float32, last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[:, -1:], **TOL)


@pytest.mark.parametrize("arch,over", MODELS, ids=IDS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_gradients_match_reference(arch, over, remat):
    tcfg, jcfg = configs(arch, **over)
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
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert H is None and float(metrics["aux"]) == 0.0


def test_embedding_is_scaled_for_gemma_only():
    for arch, scaled in (("gemma3-27b", True), ("qwen1.5-32b", False)):
        tcfg, _ = configs(arch)
        p = {"table": torch.ones((tcfg.vocab, tcfg.d_model))}
        x = tcommon.embed(tcfg, p, torch.tensor([[1, 2]]), torch.float32)
        want = np.sqrt(tcfg.d_model) if scaled else 1.0
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-7)


# ---------------------------------------------------------------------------
# Decode across the ring wrap, caches and their axes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", MODELS, ids=IDS)
def test_decode_matches_reference_and_forward_across_the_wrap(arch, over):
    """20 decode steps (window 8: every local ring wraps twice) against the
    reference's decode (1e-4 / 1e-5) and the port's own forward
    (2e-3)."""
    tcfg, jcfg = configs(arch, **over)
    jparams, tparams = weights(jcfg, seed=0)
    B, S = 2, 20
    toks = tokens(tcfg, B=B, S=S, seed=3)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    full, _, _ = tapi.logits(tparams, {"tokens": torch.from_numpy(toks)},
                             activ_dtype=torch.float32)
    jc = japi.init_decode(B, S + 2, jnp.float32)
    tc = tapi.init_decode(B, S + 2, torch.float32, device="cpu")
    jstep = jax.jit(lambda p, c, t: japi.decode_step(
        p, c, {"tokens": t}, activ_dtype=jnp.float32))
    for t in range(S):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[:, t]))
        tl, tc2 = tapi.decode_step(tparams, tc, {"tokens": torch.from_numpy(
            toks[:, t]).long()}, activ_dtype=torch.float32)
        assert tc2 is tc                         # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{arch} step {t}")
    flat_t = jax.tree_util.tree_leaves(tree_to_jax(tc))
    flat_j = jax.tree_util.tree_leaves(jc)
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    if tcfg.local_global:
        assert int(tc["local"].kpos.max()) == S - 1
        assert tc["local"].k.shape[-3] == tcfg.window < S


def tree_to_jax(caches):
    """The port's cache tree as the reference's pytree of numpy arrays
    (KVCache NamedTuples of the reference's class, in dicts)."""
    from repro.models.attention import KVCache as JKVCache
    return {k: JKVCache(*(t.numpy() for t in c)) for k, c in caches.items()}


@pytest.mark.parametrize("arch,over", MODELS, ids=IDS)
def test_cache_trees_and_axes_match_reference(arch, over):
    tcfg, jcfg = configs(arch, **over)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jc = japi.init_decode(3, 12, jnp.float32)
    tc = tapi.init_decode(3, 12, torch.float32, device="cpu")
    assert shapes(tree_to_jax(tc)) == shapes(jc)
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_jax(tc)),
                    jax.tree_util.tree_leaves(jc)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    jaxes = japi.cache_axes(jc)
    taxes = tapi.cache_axes(tc)
    assert {k: tuple(v) for k, v in taxes.items()} == \
        {k: tuple(v) for k, v in jaxes.items()}


def test_stacked_layers_are_views():
    """Every layer's params and caches under the [n_groups, k] stacks are
    views of the stack: a write through a layer's cache reaches it."""
    tcfg, _ = configs("gemma3-27b", n_layers=8)
    params, _ = split_tree(get_model(tcfg).init(torch.Generator()))
    caches = get_model(tcfg).init_decode(1, 4, torch.float32, device="cpu")
    n_groups, k, _ = ttfm._pattern(tcfg)
    stack = params["stack"]["local"]["attn"]["wq"]
    for g, lp in enumerate(ttfm.unstack(params["stack"]["local"], n_groups)):
        for j, p in enumerate(ttfm.unstack(lp, k)):
            assert p["attn"]["wq"].data_ptr() == stack[g, j].data_ptr()
    c = ttfm.unstack(ttfm.unstack(caches["local"], n_groups)[0], k)[2]
    c.pos.add_(5)
    c.k.fill_(1.0)
    assert int(caches["local"].pos[0, 2]) == 5
    assert float(caches["local"].k[0, 2].min()) == 1.0
    assert float(caches["local"].k[0, 1].max()) == 0.0
