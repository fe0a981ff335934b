"""The port's optimizer and gradient compression (`repro_torch.optim`)
against the reference's `repro.optim`, on the CPU.

Inputs come from numpy seeds; trees are nested dicts of the reference's
shape.  Tolerances: AdamW's update, moments, `global_norm` and
`warmup_cosine` within 1e-6 relative (XLA and torch may sum a norm in
another order, and XLA may contract a multiply-add); the compressors'
outputs and residuals bit-identical (their ops are single IEEE operations
in both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

RTOL = 1e-6


def trees(seed, scale=1.0):
    """(numpy tree, jax tree, torch tree) of one structure."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 6)}, "e": (11,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    t = make(shapes)
    return (t, jax.tree_util.tree_map(jnp.asarray, t),
            tree_map(lambda a: torch.from_numpy(a.copy()), t))


def assert_tree_close(ours, ref, rtol=RTOL, atol=0.0):
    flat_ref = jax.tree_util.tree_leaves(ref)
    flat = tree_leaves(ours)
    assert len(flat) == len(flat_ref)
    for a, b in zip(flat, flat_ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=atol or rtol * np.abs(b).max())


def test_tree_helpers_walk_in_reference_order():
    np_tree, jtree, ttree = trees(0)
    for a, b in zip(tree_leaves(ttree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    calls = []
    tree_map(lambda x: calls.append(x.shape), ttree)
    assert calls == [tuple(x.shape) for x in tree_leaves(ttree)]


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_global_norm_matches_reference(scale):
    _, jtree, ttree = trees(1, scale)
    np.testing.assert_allclose(float(toptim.global_norm(ttree)),
                               float(joptim.global_norm(jtree)), rtol=RTOL)


@pytest.mark.parametrize("count", [0, 1, 5, 19, 20, 21, 150, 1000])
def test_warmup_cosine_matches_reference(count):
    ours = toptim.warmup_cosine(1e-3, warmup=20, total=200)
    ref = joptim.warmup_cosine(1e-3, warmup=20, total=200)
    np.testing.assert_allclose(
        float(ours(torch.tensor(count, dtype=torch.int32))),
        float(ref(jnp.asarray(count, jnp.int32))), rtol=RTOL)


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("grad_scale", [1e-2, 5.0])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_reference(clip, grad_scale, schedule):
    """Three steps from zero moments, weight decay on: params, m, v and
    the count after each step within 1e-6 of the reference's."""
    lr = toptim.warmup_cosine(3e-2, 2, 10) if schedule else 3e-2
    jlr = joptim.warmup_cosine(3e-2, 2, 10) if schedule else 3e-2
    ours = toptim.AdamW(lr=lr, clip_norm=clip)
    ref = joptim.AdamW(lr=jlr, clip_norm=clip)
    _, jp, tp = trees(2)
    js, ts = ref.init(jp), ours.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for step in range(3):
        _, jg, tg = trees(10 + step, grad_scale)
        jp, js = ref.update(jg, js, jp)
        tp2, ts = ours.update(tg, ts, tp)
        assert tp2 is tp                      # updated in place
        assert int(ts.count) == int(js.count) == step + 1
        assert_tree_close(tp, jp)
        assert_tree_close(ts.m, js.m)
        assert_tree_close(ts.v, js.v)


def test_adamw_keeps_bf16_params_and_f32_moments():
    ours = toptim.AdamW(lr=1e-2)
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    s = ours.init(p)
    assert s.m["w"].dtype == s.v["w"].dtype == torch.float32
    p, s = ours.update({"w": torch.full((4, 4), 0.5)}, s, p)
    assert p["w"].dtype == torch.bfloat16 and float(p["w"][0, 0]) < 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abstract_inits_are_the_reference_trees_on_meta(dtype):
    """`init_abstract` and `init_ef_abstract` of meta params: the
    reference's abstract leaves (float32 moments and residuals, an int32
    count), on the meta device, nothing allocated."""
    _, jp, tp = trees(1)
    tp = tree_map(lambda a: torch.empty(a.shape, dtype=dtype,
                                        device="meta"), tp)
    got = toptim.AdamW().init_abstract(tp)
    want = joptim.AdamW().init_abstract(jp)
    ef, jef = toptim.init_ef_abstract(tp), joptim.init_ef_abstract(jp)
    leaves = [got.count] + tree_leaves(got.m) + tree_leaves(got.v) \
        + tree_leaves(ef.err)
    ref = jax.tree_util.tree_leaves(want) + jax.tree_util.tree_leaves(jef)
    assert [(tuple(a.shape), str(a.dtype), a.device.type) for a in leaves] \
        == [(tuple(b.shape), f"torch.{np.dtype(b.dtype).name}", "meta")
            for b in ref]


@pytest.mark.parametrize("which", ["int8", "topk"])
@pytest.mark.parametrize("grad_scale", [1e-4, 1.0, 300.0])
def test_compression_bit_identical_to_reference(which, grad_scale):
    """Two steps of error feedback: decompressed gradients and residuals
    equal the reference's bit for bit."""
    ours = {"int8": toptim.compress_int8_ef,
            "topk": toptim.compress_topk_ef}[which]
    ref = {"int8": joptim.compress_int8_ef,
           "topk": joptim.compress_topk_ef}[which]
    _, jp, tp = trees(3)
    jef, tef = joptim.init_ef(jp), toptim.init_ef(tp)
    for step in range(2):
        _, jg, tg = trees(20 + step, grad_scale)
        jout, jef = ref(jg, jef)
        tout, tef = ours(tg, tef)
        for a, b in zip(tree_leaves(tout) + tree_leaves(tef.err),
                        jax.tree_util.tree_leaves(jout)
                        + jax.tree_util.tree_leaves(jef.err)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
