"""The port's VLM (internvl2-1b, reduced) against the reference, on the
CPU.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`), the same patch embeddings and tokens
(numpy, fixed seeds), in float32.  Tolerances: 1e-5 abs / 1e-4 rel for
logits, loss and every gradient leaf; decode against the reference's
within the same, against the port's forward within 2e-3; the launcher's
losses over 2 steps from the reference's initial train state within 1e-4
(relative; AdamW's first update turns the rounding of a gradient near 0
into a change of up to 2 lr).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

ARCH = "internvl2-1b"
TOL = dict(rtol=1e-4, atol=1e-5)


def configs(arch=ARCH, **over):
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


def batch(cfg, B=2, S=13, seed=0):
    rng = np.random.default_rng(seed)
    return {"patch_embeds": rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_init_tree_matches_reference():
    tcfg, jcfg = configs()
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    assert shapes(tvals) == shapes(jvals)
    assert taxes == jaxes
    assert sorted(tvals["projector"]) == ["ln", "w1", "w2"]


def test_projector_matches_reference():
    from repro.models import vlm as jvlm
    tcfg, jcfg = configs()
    jparams, tparams = weights(jcfg)
    b = batch(tcfg)
    got = tvlm._project(tcfg, tparams, torch.from_numpy(b["patch_embeds"]),
                        torch.float32)
    want = jvlm._project(jcfg, jparams, jnp.asarray(b["patch_embeds"]),
                         jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_lm_logits_match_reference(last_only):
    tcfg, jcfg = configs()
    jparams, tparams = weights(jcfg)
    b = batch(tcfg)
    want, _, _ = jget_model(jcfg).logits(jparams, as_jax(b),
                                         activ_dtype=jnp.float32,
                                         last_only=last_only)
    got, H, _ = get_model(tcfg).logits(tparams, as_torch(b),
                                       activ_dtype=torch.float32,
                                       last_only=last_only)
    assert H is None
    assert got.shape == ((2, 1, tcfg.vocab) if last_only else
                         (2, tcfg.n_patches + 13, tcfg.vocab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_gradients_match_reference(remat):
    """The loss on the text positions only, and a gradient on every leaf,
    the projector's included."""
    tcfg, jcfg = configs()
    jparams, tparams = weights(jcfg)
    b = batch(tcfg, S=14)

    def jloss(p):
        return jget_model(jcfg).loss(p, as_jax(b), activ_dtype=jnp.float32,
                                     remat=remat)
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
    loss, (H, metrics) = get_model(tcfg).loss(
        leaves, as_torch(b), activ_dtype=torch.float32, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert H is None and set(metrics) == {"ce"}
    ref = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    by_leaf = {id(p): g for p, g in zip(tree_leaves(leaves), grads)}
    for name in ("w1", "w2"):
        assert float(by_leaf[id(leaves["projector"][name])].abs().max()) > 0


def test_decode_matches_reference_and_forward():
    """The reference's decode case (S=12, B=2): the VLM decodes through the
    backbone's caches; its logits against the reference's and against the
    backbone's forward over the same tokens."""
    tcfg, jcfg = configs()
    jparams, tparams = weights(jcfg, seed=0)
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, tcfg.vocab,
                                             (B, S)).astype(np.int32)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    full, _, _ = ttfm.lm_logits(tcfg, tparams, torch.from_numpy(toks),
                                activ_dtype=torch.float32)
    jc = japi.init_decode(B, S + 2, jnp.float32)
    tc = tapi.init_decode(B, S + 2, torch.float32, device="cpu")
    for t in range(S):
        jl, jc = japi.decode_step(jparams, jc, {"tokens": jnp.asarray(
            toks[:, t])}, activ_dtype=jnp.float32)
        tl, tc = tapi.decode_step(tparams, tc, {"tokens": torch.from_numpy(
            toks[:, t]).long()}, activ_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)
    assert tapi.cache_axes(tc)["layers"].k == \
        japi.cache_axes(jc)["layers"].k


def launcher_losses(arch, monkeypatch, extra=()):
    """2 steps of each launcher (B=2, seq 12, float32) from the reference's
    initial train state: the port's `init_train_state` is replaced by the
    reference's state carried across."""
    args = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "12", *extra]
    jlosses = jtrain.main(args)

    def reference_state(rcfg, gen, *, device=None, optimizer=None):
        jcfg = jconfigs.reduced(jconfigs.get_config(arch))
        jrcfg = jconfigs.RunConfig(model=jcfg, shape=jconfigs.ShapeConfig(
            "custom", 12, 2, "train"), remat=rcfg.remat,
            activ_dtype="float32")
        jstate, _ = jstep.init_train_state(jrcfg, key=jax.random.key(0))
        return train_state_from_numpy(to_numpy(jstate), device), None
    monkeypatch.setattr(ttrain, "init_train_state", reference_state)
    losses = ttrain.main(args + ["--device", "cpu"])
    return losses, jlosses


def test_launcher_vlm_batch_matches_reference(monkeypatch):
    losses, jlosses = launcher_losses(ARCH, monkeypatch)
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
