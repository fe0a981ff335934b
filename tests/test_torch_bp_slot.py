"""Parity of the port's slot-decision kernels (bp_slot) with the reference.

On the CPU the port's wrappers run their plain PyTorch versions; these
must equal the JAX package's Pallas kernels (interpret mode) and its
`ref.py` bit for bit: indices, `dmax` and `Z`.  The `gpu`-marked test holds
the CUDA kernels to the plain versions on the card and skips without one;
it needs no JAX, so it runs on a card machine without it.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bp_slot import kernel as tkernel  # noqa: E402
from repro_torch.kernels.bp_slot import ops as tops  # noqa: E402
from repro_torch.kernels.bp_slot import ref as tref  # noqa: E402
from repro_torch.kernels.bp_slot.ref import PANELS  # noqa: E402


# ---------------------------------------------------------------------------
# Inputs (numpy, fixed seeds)
# ---------------------------------------------------------------------------

def route_inputs(rng, B, N, C, E, ties=False, pad_e=0):
    """Qf [B, N, C] f32 and endpoints [B, E] i32.  ``ties``: small integer
    backlogs with the class block repeated (exact ties across classes).
    ``pad_e`` trailing edges are (0, 0) self-loops, as padding makes them."""
    if ties:
        base = rng.integers(0, 4, size=(B, N, C // 3)).astype(np.float32)
        Qf = np.concatenate([base] * 3, axis=2)
        Qf[:, 1] = 0.0                               # an all-zero row
    else:
        Qf = (rng.random((B, N, C)) * 100).astype(np.float32)
    m = rng.integers(0, N, size=(B, E)).astype(np.int32)
    l = ((m + 1 + rng.integers(0, N - 1, size=(B, E))) % N).astype(np.int32)
    if pad_e:
        m[:, -pad_e:] = 0
        l[:, -pad_e:] = 0
    if ties:
        m[:, 0], l[:, 0] = 1, 1                      # zero row vs itself
    return Qf, m, l


def balance_inputs(rng, B, NC, mask="random", ties=False):
    """eps [B] and the 12 panels [B, NC] in `PANELS` order."""
    def r(lo, hi):
        if ties:
            return rng.integers(int(lo), int(hi) + 1,
                                size=(B, NC)).astype(np.float32)
        return (lo + rng.random((B, NC)) * (hi - lo)).astype(np.float32)
    p = dict(q0=r(0, 10), q1=r(0, 10), q2=r(0, 10), H=r(0, 10),
             caps=r(1, 3), x1=r(0, 10), x2=r(0, 10), ca1=r(5, 20),
             ca2=r(5, 20), cc=r(0, 5), x_net=r(0, 10))
    if mask == "random":
        p["mask"] = (rng.random((B, NC)) > 0.4).astype(np.float32)
        p["mask"][0] = 0.0                           # one sim all masked
    else:
        p["mask"] = np.ones((B, NC), np.float32)
    eps = rng.choice(np.float32([0.0, 0.01, 0.05, 0.3]), size=B)
    return eps.astype(np.float32), [p[k] for k in PANELS]


@pytest.fixture(scope="module")
def J():
    """The JAX reference: jax plus the reference's bp_slot modules."""
    jax = pytest.importorskip("jax")
    from repro.kernels.bp_slot import kernel, ops, ref
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, kernel=kernel,
                                 ops=ops, ref=ref)


def jax_route(J, Qf, m, l):
    f = J.jax.vmap(lambda q, a, b: J.kernel.slot_route_decide(
        q, a, b, block_e=16, block_c=5, interpret=True))
    best, dmax = J.jax.jit(f)(Qf, m, l)
    return np.asarray(best), np.asarray(dmax)


def jax_balance(J, eps, panels, **kw):
    f = J.jax.vmap(lambda e, *p: J.kernel.comp_balance_decide(
        e, *p, block_n=3, interpret=True, **kw))
    Z, n = f(J.jnp.asarray(eps), *map(J.jnp.asarray, panels))
    return np.asarray(Z), np.asarray(n)


def jax_balance_ref(J, eps, panels, **kw):
    f = J.jax.vmap(lambda e, *p: J.ref.comp_balance_ref(e, *p, **kw))
    Z, n = f(J.jnp.asarray(eps), *map(J.jnp.asarray, panels))
    return np.asarray(Z), np.asarray(n)


def _bits(a):
    """Bit patterns of a float32 array, for bit-for-bit comparisons."""
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# slot_route_decide
# ---------------------------------------------------------------------------

class TestRouteDecide:
    @pytest.mark.parametrize("ties", [False, True])
    def test_plain_matches_jax_kernel_and_ref(self, J, ties):
        rng = np.random.default_rng(11 + ties)
        Qf, m, l = route_inputs(rng, B=4, N=16, C=12, E=51, ties=ties,
                                pad_e=5)
        jb, jd = jax_route(J, Qf, m, l)
        rb, rd = J.jax.vmap(J.ref.slot_route_ref)(Qf, m, l)
        tb, td = tkernel.slot_route_decide(torch.from_numpy(Qf),
                                           torch.from_numpy(m),
                                           torch.from_numpy(l))
        assert tb.dtype == torch.int32 and td.dtype == torch.float32
        np.testing.assert_array_equal(tb.numpy(), jb)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
        np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))
        np.testing.assert_array_equal(_bits(td.numpy()), _bits(rd))
        # padded self-loops and the zero row keep index 0 and a zero diff
        assert (tb.numpy()[:, -5:] == 0).all()
        assert (td.numpy()[:, -5:] == 0).all()
        if ties:
            assert (tb.numpy()[:, 0] == 0).all()
            assert (tb.numpy() < 4).all()            # ties resolve low

    def test_wrapper_checks_inputs(self):
        Qf = torch.zeros((2, 4, 6))
        m = torch.zeros((2, 3), dtype=torch.int32)
        with pytest.raises(TypeError):
            tkernel.slot_route_decide(Qf, m.long(), m)
        with pytest.raises(ValueError):
            tkernel.slot_route_decide(Qf[:, :, ::2], m, m)
        with pytest.raises(ValueError):
            tkernel.slot_route_decide(Qf, m[:1], m)

    def test_cpu_does_not_count_launches(self):
        before = tkernel.slot_route_decide.launches
        Qf, m, l = route_inputs(np.random.default_rng(0), 2, 5, 6, 4)
        tkernel.slot_route_decide(torch.from_numpy(Qf), torch.from_numpy(m),
                                  torch.from_numpy(l))
        assert tkernel.slot_route_decide.launches == before

    def test_op_full_decision_matches_jax(self, J):
        rng = np.random.default_rng(9)
        B, N, NC, E = 3, 16, 4, 45
        Q = (rng.random((B, N, 3, NC)) * 100).astype(np.float32)
        edges = rng.integers(0, N, size=(B, E, 2)).astype(np.int32)
        edges[..., 1] = (edges[..., 1] + 1 + edges[..., 0]) % N
        cap = (rng.random((B, E)) * 5).astype(np.float32)
        out = tops.slot_route_op(*map(torch.from_numpy, (Q, edges, cap)))
        ref = tops.slot_route_op_ref(*map(torch.from_numpy, (Q, edges, cap)))
        want = J.jax.vmap(J.ops.slot_route_op_ref)(Q, edges, cap)
        for got, r, w, name in zip(out, ref, want,
                                   ("class", "comp", "dir", "rate")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                          err_msg=name)
            np.testing.assert_array_equal(got.numpy(), r.numpy(),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# comp_balance_decide
# ---------------------------------------------------------------------------

class TestCompBalanceDecide:
    @pytest.mark.parametrize("seed,pairing,thresholded,ties", [
        (0, "fifo", False, False), (1, "bound", False, False),
        (2, "fifo", True, False), (3, "fifo", False, True),
        (4, "bound", True, True)])
    def test_plain_matches_jax_kernel_and_ref(self, J, seed, pairing,
                                              thresholded, ties):
        rng = np.random.default_rng(seed)
        eps, panels = balance_inputs(rng, B=6, NC=5, ties=ties)
        kw = dict(pairing=pairing, thresholded=thresholded, threshold=4.0)
        jZ, jn = jax_balance(J, eps, panels, **kw)
        rZ, rn = jax_balance_ref(J, eps, panels, **kw)
        tZ, tn = tkernel.comp_balance_decide(
            torch.from_numpy(eps), *map(torch.from_numpy, panels), **kw)
        assert tZ.dtype == torch.float32 and tn.dtype == torch.int32
        np.testing.assert_array_equal(_bits(tZ.numpy()), _bits(jZ))
        np.testing.assert_array_equal(_bits(tZ.numpy()), _bits(rZ))
        np.testing.assert_array_equal(tn.numpy(), jn)
        np.testing.assert_array_equal(tn.numpy(), rn)
        assert tn[0] == 0                             # all masked -> 0
        mask = panels[PANELS.index("mask")]
        for b in range(1, 6):
            if mask[b].any():
                assert mask[b, int(tn[b])] == 1.0

    def test_eps_is_per_sim(self, J):
        rng = np.random.default_rng(5)
        eps, panels = balance_inputs(rng, B=4, NC=4, mask="none")
        panels[0][:] = 8.0                            # q0 equal everywhere
        t = [torch.from_numpy(p) for p in panels]
        _, n0 = tkernel.comp_balance_decide(torch.zeros(4), *t)
        _, n1 = tkernel.comp_balance_decide(torch.full((4,), 1.0), *t)
        jZ, jn = jax_balance(J, np.full(4, 1.0, np.float32), panels)
        np.testing.assert_array_equal(n1.numpy(), jn)
        assert n0.shape == n1.shape == (4,)


# ---------------------------------------------------------------------------
# Import and card checks
# ---------------------------------------------------------------------------

def test_kernel_module_imports_without_nvcc():
    """The wrappers build nothing at import: with no nvcc on PATH and no
    CUDA_HOME the modules import and the CPU path runs."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = "/nonexistent"
    code = ("import torch; from repro_torch.kernels.bp_slot import kernel, ops;"
            "b, d = kernel.slot_route_decide(torch.zeros(1, 2, 3),"
            " torch.zeros(1, 1, dtype=torch.int32),"
            " torch.ones(1, 1, dtype=torch.int32)); print(int(b[0, 0]))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


@pytest.mark.gpu
def test_cuda_kernels_match_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    for ties in (False, True):
        Qf, m, l = route_inputs(rng, B=64, N=16, C=12, E=51, ties=ties,
                                pad_e=3)
        args = [torch.from_numpy(a).cuda() for a in (Qf, m, l)]
        before = tkernel.slot_route_decide.launches
        b, d = tkernel.slot_route_decide(*args)
        torch.cuda.synchronize()
        assert tkernel.slot_route_decide.launches == before + 1
        rb, rd = tref.slot_route_ref(*args)
        assert torch.equal(b, rb)
        assert torch.equal(d.view(torch.int32), rd.view(torch.int32))
        for pairing in ("fifo", "bound"):
            for thresholded in (False, True):
                eps, panels = balance_inputs(rng, B=64, NC=4, ties=ties)
                t = [torch.from_numpy(p).cuda() for p in (eps, *panels)]
                kw = dict(pairing=pairing, thresholded=thresholded,
                          threshold=3.0)
                Z, n = tkernel.comp_balance_decide(*t, **kw)
                rZ, rn = tref.comp_balance_ref(*t, **kw)
                torch.cuda.synchronize()
                assert torch.equal(n, rn)
                assert torch.equal(Z, rZ)
