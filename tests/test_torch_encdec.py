"""The port's encoder-decoder (seamless-m4t-large-v2, reduced) against the
reference, on the CPU.

Both packages run from the same weights (the reference's, carried across
by `convert.params_from_numpy`), the same frames and tokens (numpy, fixed
seeds), in float32.  Tolerances: 1e-5 abs / 1e-4 rel for the memory,
logits, loss, every gradient leaf and the cross caches; decode against
the reference's decode within the same and against the port's own
`decode_fwd` within 2e-3 (`tests/test_models_consistency.py`'s case,
S=12, B=2); the launcher's losses as in `test_torch_vlm.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import encdec as jencdec  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import get_model, split_tree  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from test_torch_vlm import (TOL, as_jax, as_torch, configs,  # noqa: E402
                            launcher_losses, shapes, weights)

ARCH = "seamless-m4t-large-v2"
B, S = 2, 12


def batch(cfg, S_src=10, S_tgt=13, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, S_src, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab,
                                   (B, S_tgt)).astype(np.int32)}


def cache_arrays(c):
    """An EncDecCache's leaves as numpy arrays, in the reference's order."""
    return [t.numpy() for t in (*c.self_kv, c.cross_k, c.cross_v)]


def test_init_tree_matches_reference():
    tcfg, jcfg = configs(ARCH)
    tvals, taxes = split_tree(get_model(tcfg).init(
        torch.Generator().manual_seed(0)))
    jvals, jaxes = jsplit(jget_model(jcfg).init(abstract=True))
    assert shapes(tvals) == shapes(jvals)
    assert taxes == jaxes
    assert tvals["encoder"]["attn"]["wq"].shape[0] == tcfg.enc_layers
    assert tvals["decoder"]["xattn"]["wq"].shape[0] == tcfg.dec_layers


@pytest.mark.parametrize("last_only", [False, True])
def test_encode_and_lm_logits_match_reference(last_only):
    tcfg, jcfg = configs(ARCH)
    jparams, tparams = weights(jcfg)
    b = batch(tcfg)
    mem = tencdec.encode(tcfg, tparams, torch.from_numpy(b["frames"]),
                         remat="none")
    jmem = jencdec.encode(jcfg, jparams, jnp.asarray(b["frames"]),
                          remat="none")
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    want, _, _ = jget_model(jcfg).logits(jparams, as_jax(b),
                                         activ_dtype=jnp.float32,
                                         last_only=last_only)
    got, H, aux = get_model(tcfg).logits(tparams, as_torch(b),
                                         activ_dtype=torch.float32,
                                         last_only=last_only)
    assert H is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_gradients_match_reference(remat):
    tcfg, jcfg = configs(ARCH)
    jparams, tparams = weights(jcfg)
    b = batch(tcfg)

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
        assert float(g.abs().max()) > 0


def test_build_cross_cache_matches_reference():
    tcfg, jcfg = configs(ARCH)
    jparams, tparams = weights(jcfg)
    mem = np.random.default_rng(4).standard_normal(
        (B, 9, tcfg.d_model)).astype(np.float32)
    got = tencdec.build_cross_cache(tcfg, tparams, torch.from_numpy(mem),
                                    S + 2, torch.float32)
    want = jencdec.build_cross_cache(jcfg, jparams, jnp.asarray(mem), S + 2,
                                     jnp.float32)
    assert isinstance(got.self_kv, KVCache)
    for a, w in zip(cache_arrays(got), jax.tree_util.tree_leaves(want)):
        assert a.shape == np.asarray(w).shape
        np.testing.assert_allclose(a, np.asarray(w), **TOL)


def test_decode_matches_reference_and_forward():
    """`tests/test_models_consistency.py`'s encdec case: frames -> memory
    -> `decode_fwd` logits; the cross cache; 12 decode steps."""
    tcfg, jcfg = configs(ARCH)
    jparams, tparams = weights(jcfg, seed=0)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    mem = tencdec.encode(tcfg, tparams, torch.from_numpy(frames),
                         remat="none")
    full = tencdec.decode_fwd(tcfg, tparams, torch.from_numpy(toks), mem,
                              activ_dtype=torch.float32, remat="none")
    caches = tencdec.build_cross_cache(tcfg, tparams, mem, S + 2,
                                       torch.float32)
    jmem = jencdec.encode(jcfg, jparams, jnp.asarray(frames), remat="none")
    jc = jencdec.build_cross_cache(jcfg, jparams, jmem, S + 2, jnp.float32)
    api, japi = get_model(tcfg), jget_model(jcfg)
    for t in range(S):
        tl, caches2 = api.decode_step(tparams, caches, {
            "tokens": torch.from_numpy(toks[:, t]).long()},
            activ_dtype=torch.float32)
        assert caches2 is caches                     # written in place
        jl, jc = japi.decode_step(jparams, jc, {"tokens": jnp.asarray(
            toks[:, t])}, activ_dtype=jnp.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"step {t}")
    for a, w in zip(cache_arrays(caches), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(w), **TOL)
    assert int(caches.self_kv.pos[0]) == S


def test_cache_trees_and_axes_match_reference():
    tcfg, jcfg = configs(ARCH)
    tc = get_model(tcfg).init_decode(3, 7, torch.float32, device="cpu")
    jc = jget_model(jcfg).init_decode(3, 7, jnp.float32)
    for a, w in zip(cache_arrays(tc), jax.tree_util.tree_leaves(jc)):
        assert a.shape == np.asarray(w).shape and \
            a.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a, np.asarray(w))
    taxes, jaxes = get_model(tcfg).cache_axes(tc), \
        jget_model(jcfg).cache_axes(jc)
    assert tuple(taxes.self_kv) == tuple(jaxes.self_kv)
    assert (taxes.cross_k, taxes.cross_v) == (jaxes.cross_k, jaxes.cross_v)


def test_launcher_encdec_batch_matches_reference(monkeypatch):
    losses, jlosses = launcher_losses(ARCH, monkeypatch)
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
