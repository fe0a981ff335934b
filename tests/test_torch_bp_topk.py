"""Parity of the port's fused backpressure top-k gate (bp_topk) and of
the whole gate of one MoE layer (bp_topk_route) with the reference.

On the CPU the port's wrappers run their plain PyTorch versions.
`bp_topk` must pick the same experts as the JAX package's Pallas kernel
(interpret mode) and its `bp_topk_ref`, with weights within rtol 1e-5 /
atol 1e-6 (the bound of `tests/test_kernels.py`: XLA sums the softmax in
another order, so the weights agree to rounding, not bit for bit).
`bp_topk_route_ref` must give what the JAX package's `moe._route` gives
with ``use_kernel=True`` and ``False``: the same experts, the same counts
and steps, H_new within atol 1e-6 (the same float32 operations), and
weights within rtol 1e-5 / atol 1e-6 in float32 or one bfloat16 ulp
(rtol 2^-7) in bfloat16, where the two roundings of nearly equal float32
weights may land on neighbouring bf16 values.  The `gpu`-marked tests
hold the CUDA kernels to their plain versions bit for bit on the card and
skip without one; they need no JAX, so they run on a card machine
without it.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bp_topk import kernel as tkernel  # noqa: E402
from repro_torch.kernels.bp_topk.ops import bp_topk_op  # noqa: E402
from repro_torch.kernels.bp_topk.ref import (bp_topk_ref,  # noqa: E402
                                              bp_topk_route_ref, warp_sum)

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


# ---------------------------------------------------------------------------
# bp_topk_route: the whole gate of one MoE layer
# ---------------------------------------------------------------------------

#: (G, Tg, E, k): granite's 32 experts top-8 and moonshot's 64 top-6 at a
#: decode step and a short prefill, and a small ragged gate.
ROUTE_SHAPES = [(4, 1, 32, 8), (2, 16, 32, 8), (1, 24, 64, 6), (3, 5, 8, 2)]


def route_inputs(rng, G, Tg, E, k, ties):
    """Router logits [G, Tg, E] (normal, or integer-valued in [-2, 2] with
    one all-equal row) and non-zero integer queues H [E] in [0, 4): equal
    logits of experts with equal H stay exact ties after the bias."""
    if ties:
        x = rng.integers(-2, 3, size=(G, Tg, E)).astype(np.float32)
        x[0, 0] = 1.0
    else:
        x = rng.standard_normal((G, Tg, E)).astype(np.float32)
    H = rng.integers(0, 4, size=E).astype(np.float32)
    H[0] = 1.0
    return x, H


def jax_route(x, H, k, router, dtype, use_kernel):
    """`repro.models.moe._route` with an identity router, so its logits are
    ``x`` itself (exact in float32 and in bfloat16)."""
    jax = pytest.importorskip("jax")
    from repro.core.router import RouterState as JState
    from repro.models import moe as jmoe
    jnp = jax.numpy
    E = x.shape[-1]
    cfg = types.SimpleNamespace(n_experts=E, top_k=k, router=router)
    jdt = getattr(jnp, dtype)
    out = jmoe._route(cfg, {"router": jnp.eye(E, dtype=jnp.float32)},
                      jnp.asarray(x).astype(jdt),
                      JState(jnp.asarray(H), jnp.zeros((), jnp.int32)),
                      use_kernel=use_kernel)
    idx, w, st, _, counts = out
    return (np.asarray(idx), np.asarray(w.astype(jnp.float32)),
            np.asarray(counts), np.asarray(st.H), int(st.steps))


def port_route(x, H, k, router, dtype):
    G, Tg, E = x.shape
    logits = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(G * Tg, E)
    idx, w, counts, H_new, steps = tkernel.bp_topk_route(
        logits, torch.from_numpy(H), torch.zeros((), dtype=torch.int32),
        G * Tg * k / E, k, backpressure=router == "backpressure")
    assert idx.dtype == torch.int64 and w.dtype == logits.dtype
    return (idx.reshape(G, Tg, k).numpy(), w.float().reshape(G, Tg, k).numpy(),
            counts.numpy(), H_new.numpy(), int(steps))


@pytest.mark.parametrize("G,Tg,E,k", ROUTE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("router", ["backpressure", "plain"])
@pytest.mark.parametrize("ties", [False, True])
def test_route_ref_matches_jax_route(G, Tg, E, k, dtype, router, ties):
    x, H = route_inputs(np.random.default_rng(G + Tg + E + k), G, Tg, E, k,
                        ties)
    got = port_route(x, H, k, router, dtype)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2.0 ** -7, atol=0)
    for use_kernel in (True, False):
        want = jax_route(x, H, k, router, dtype, use_kernel)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], **tol)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6)
        assert got[4] == want[4] == 1
    if ties:                          # an all-equal row: experts 0..k-1
        if router == "plain" or (H == H[0]).all():
            np.testing.assert_array_equal(got[0][0, 0], np.arange(k))
    assert got[2].sum() == G * Tg * k


def test_route_ref_is_bp_topk_with_the_routers_ops():
    """The fused gate's plain version equals, bit for bit, the gate the
    port ran before it: `bp_topk_ref` on the float32 logits, then the
    counts, H update and steps of `moe._route`."""
    rng = np.random.default_rng(11)
    x, H = route_inputs(rng, 2, 8, 32, 8, False)
    logits = torch.from_numpy(x).reshape(16, 32)
    Ht = torch.from_numpy(H) * 0.75
    steps = torch.tensor(5, dtype=torch.int32)
    cap = 16 * 8 / 32
    cap_t = torch.full((), cap, dtype=torch.float32)
    idx, w = bp_topk_ref(logits, Ht / torch.clamp(cap_t, min=1.0), 8)
    counts = torch.nn.functional.one_hot(idx.long().reshape(-1), 32).sum(
        0).to(torch.float32)
    got = bp_topk_route_ref(logits, Ht, steps, cap, 8, True)
    assert torch.equal(got[0], idx.long()) and torch.equal(got[1], w)
    assert torch.equal(got[2], counts)
    assert torch.equal(got[3], torch.clamp(Ht + counts - cap_t, min=0.0))
    assert int(got[4]) == 6 and got[4].dtype == torch.int32


def test_route_wrapper_rejects_bad_inputs():
    logits, H = torch.zeros((4, 8)), torch.zeros(8)
    steps = torch.zeros((), dtype=torch.int32)
    f = tkernel.bp_topk_route
    with pytest.raises(TypeError):
        f(logits.double(), H, steps, 1.0, 2, True)
    with pytest.raises(TypeError):
        f(logits, H.double(), steps, 1.0, 2, True)
    with pytest.raises(TypeError):
        f(logits, H, steps.long(), 1.0, 2, True)
    with pytest.raises(ValueError):
        f(logits, torch.zeros(7), steps, 1.0, 2, True)
    with pytest.raises(ValueError):
        f(logits, H, steps, 1.0, 9, True)
    with pytest.raises(ValueError):
        f(torch.zeros((8, 4)).T, H, steps, 1.0, 2, True)
    before = f.launches
    f(logits, H, steps, 1.0, 2, True)
    assert f.launches == before                     # CPU: no launch counted


def _route_case(rng, T, E, ties, dtype, scale):
    if ties:
        s = rng.integers(-2, 3, size=(T, E)).astype(np.float32)
        s[0] = 1.0
    else:
        s = (rng.standard_normal((T, E)) * scale).astype(np.float32)
    H = rng.integers(0, 6, size=E).astype(np.float32) * 0.5
    return (torch.from_numpy(s).to(dtype).cuda(), torch.from_numpy(H).cuda())


@pytest.mark.gpu
def test_route_cuda_kernel_matches_plain_bitwise():
    """Four-lanes-per-row path (T >= 16,384, E = 32 or 64; aligned and
    with rows starting one element in), warp-per-row register path
    (E <= 256, k <= 32) and shared-memory path (larger E, or k > 32),
    float32 and bfloat16, backpressure and plain, random and tie-heavy
    rows, and each case launched twice back to back: the second launch
    must give the same counts, so the first left its workspace zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    shapes = [(4, 32, 8), (8, 32, 8), (1024, 64, 6), (4096, 32, 8),
              (37, 8, 2), (33, 100, 7), (5, 256, 32), (19, 300, 7),
              (16, 64, 40), (16383, 32, 8), (32768, 32, 8),
              (16384, 64, 6), (16384, 64, 40), (-16384, 32, 8)]
    for T, E, k in shapes:
        unaligned, T = T < 0, abs(T)
        for dtype in (torch.float32, torch.bfloat16):
            for ties, bp in ((False, True), (True, True), (True, False)):
                logits, H = _route_case(rng, T, E, ties, dtype, 1.0)
                if unaligned:           # rows start one element in
                    buf = torch.empty(T * E + 1, dtype=dtype, device="cuda")
                    buf[1:].copy_(logits.reshape(-1))
                    logits = buf[1:].view(T, E)
                steps = torch.tensor(3, dtype=torch.int32, device="cuda")
                cap = T * k / E
                want = bp_topk_route_ref(logits, H, steps, cap, k, bp)
                for _ in range(2):
                    before = tkernel.bp_topk_route.launches
                    got = tkernel.bp_topk_route(logits, H, steps, cap, k, bp)
                    torch.cuda.synchronize()
                    assert tkernel.bp_topk_route.launches == before + 1
                    case = (T, E, k, dtype, ties, bp)
                    for a, b in zip(got, want):
                        assert a.dtype == b.dtype and a.shape == b.shape
                        assert torch.equal(a, b), case
                    if dtype == torch.float32:
                        assert torch.equal(got[1].view(torch.int32),
                                           want[1].view(torch.int32)), case
