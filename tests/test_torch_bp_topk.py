"""Parity of the port's fused backpressure top-k gate (bp_topk) with the
reference.

On the CPU the port's wrapper runs its plain PyTorch version; it must pick
the same experts as the JAX package's Pallas kernel (interpret mode) and
its `bp_topk_ref`, with weights within rtol 1e-5 / atol 1e-6 (the bound of
`tests/test_kernels.py`: XLA sums the softmax in another order, so the
weights agree to rounding, not bit for bit).  The `gpu`-marked test holds
the CUDA kernel to the plain version bit for bit on the card and skips
without one; it needs no JAX, so it runs on a card machine without it.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bp_topk import kernel as tkernel  # noqa: E402
from repro_torch.kernels.bp_topk.ops import bp_topk_op  # noqa: E402
from repro_torch.kernels.bp_topk.ref import bp_topk_ref, warp_sum  # noqa: E402

SHAPES = [(8, 32, 8), (1024, 64, 6), (37, 8, 2)]


def gate_inputs(rng, T, E, ties=False, bias="random"):
    """scores [T, E] and bias [E], float32.  ``ties``: integer-valued
    logits in [-2, 2], so rows hold exact ties; ``bias``: "zero",
    "random" (uniform [0, 0.5)) or "step" (multiples of 1/8, exact ties
    survive the subtraction)."""
    if ties:
        s = rng.integers(-2, 3, size=(T, E)).astype(np.float32)
    else:
        s = rng.standard_normal((T, E)).astype(np.float32)
    if bias == "zero":
        b = np.zeros(E, np.float32)
    elif bias == "step":
        b = (rng.integers(0, 2, size=E) / 8).astype(np.float32)
    else:
        b = (rng.random(E) * 0.5).astype(np.float32)
    return s, b


@pytest.fixture(scope="module")
def J():
    """The JAX reference: the Pallas kernel (interpret mode) and its ref."""
    jax = pytest.importorskip("jax")
    from repro.kernels.bp_topk.kernel import bp_topk
    from repro.kernels.bp_topk.ref import bp_topk_ref as ref
    return types.SimpleNamespace(jnp=jax.numpy, kernel=bp_topk, ref=ref)


def port(s, b, k):
    idx, w = tkernel.bp_topk(torch.from_numpy(s), torch.from_numpy(b), k)
    return idx.numpy(), w.numpy()


def assert_matches_jax(J, s, b, k):
    idx, w = port(s, b, k)
    for jidx, jw in (J.kernel(J.jnp.asarray(s), J.jnp.asarray(b), k),
                     J.ref(J.jnp.asarray(s), J.jnp.asarray(b), k)):
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-5, atol=1e-6)
    return idx, w


@pytest.mark.parametrize("T,E,k", SHAPES)
@pytest.mark.parametrize("bias", ["zero", "random"])
def test_plain_matches_pallas_kernel_and_ref(J, T, E, k, bias):
    s, b = gate_inputs(np.random.default_rng(T + E + k), T, E, bias=bias)
    idx, w = assert_matches_jax(J, s, b, k)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("T,E,k", SHAPES + [(16, 100, 7)])
@pytest.mark.parametrize("bias", ["zero", "step"])
def test_tie_heavy_rows_lowest_index_wins(J, T, E, k, bias):
    s, b = gate_inputs(np.random.default_rng(7), T, E, ties=True, bias=bias)
    s[0] = 1.0                                   # one row of all-equal logits
    idx, _ = assert_matches_jax(J, s, b, k)
    sel = s.astype(np.float64)                   # softmax is monotone: the
    sel = np.exp(sel - sel.max(1, keepdims=True))  # same order as probs
    sel = sel / sel.sum(1, keepdims=True) - b
    for t in range(T):
        # stable sort on -sel: equal values keep index order
        want = np.argsort(-np.round(sel[t], 12), kind="stable")[:k]
        np.testing.assert_array_equal(idx[t], want)
    if bias == "zero":
        np.testing.assert_array_equal(idx[0], np.arange(k))


def test_warp_sum_is_a_sum_in_the_kernels_order():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((5, 70)).astype(np.float32))
    # the spelled order: lane l adds l, l+32, l+64; then halving over lanes
    lanes = [sum((x[:, e] for e in range(l, 70, 32)), torch.zeros(5))
             for l in range(32)]
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    assert torch.equal(warp_sum(x), lanes[0])
    np.testing.assert_allclose(warp_sum(x).numpy(), x.double().sum(1).numpy(),
                               rtol=1e-6)


def test_bias_bans_an_expert_and_op_keeps_leading_axes():
    rng = np.random.default_rng(1)
    s, _ = gate_inputs(rng, 2 * 16, 16)
    ban = np.zeros(16, np.float32)
    ban[0] = 1e6
    idx, _ = port(s, ban, 4)
    assert not (idx == 0).any()
    gi, gw = bp_topk_op(torch.from_numpy(s).reshape(2, 16, 16),
                        torch.from_numpy(ban), 4)
    assert gi.shape == (2, 16, 4) and gw.shape == (2, 16, 4)
    np.testing.assert_array_equal(gi.reshape(-1, 4).numpy(), idx)


def test_wrapper_rejects_bad_inputs():
    s = torch.zeros((4, 8))
    b = torch.zeros(8)
    with pytest.raises(TypeError):
        tkernel.bp_topk(s.double(), b.double(), 2)
    with pytest.raises(ValueError):
        tkernel.bp_topk(s, torch.zeros(7), 2)
    with pytest.raises(ValueError):
        tkernel.bp_topk(s, b, 9)
    with pytest.raises(ValueError):
        tkernel.bp_topk(torch.zeros((8, 4)).T, b[:4].clone(), 2)
    before = tkernel.bp_topk.launches
    tkernel.bp_topk(s, b, 2)
    assert tkernel.bp_topk.launches == before       # CPU: no launch counted


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for T, E, k in SHAPES + [(4096, 32, 8), (33, 100, 7)]:
        for ties, bias in ((False, "random"), (True, "zero"), (True, "step")):
            s, b = gate_inputs(rng, T, E, ties=ties, bias=bias)
            sc, bc = torch.from_numpy(s).cuda(), torch.from_numpy(b).cuda()
            before = tkernel.bp_topk.launches
            idx, w = tkernel.bp_topk(sc, bc, k)
            ridx, rw = bp_topk_ref(sc, bc, k)
            torch.cuda.synchronize()
            assert tkernel.bp_topk.launches == before + 1
            assert torch.equal(idx, ridx), (T, E, k, ties, bias)
            assert torch.equal(w.view(torch.int32), rw.view(torch.int32))
