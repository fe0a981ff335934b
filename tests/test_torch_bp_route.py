"""Parity of the port's per-link routing decision (bp_route) with the
reference.

On the CPU the port's wrapper runs its plain PyTorch version; its classes,
rates and directions must equal, element for element, those of the JAX
package's Pallas kernel (interpret mode, through `bp_route_op` and
`bp_route_decide`) and of its `bp_route_ref`, at `tests/test_kernels.py`'s
(E, C, N) grid in float32 and bfloat16, and on tie-heavy rows and all-zero
differentials.  Exact equality is the bound: every step is exact or one
float32 subtraction.  The `gpu`-marked tests hold the CUDA kernel to the
plain version bit for bit on the card and skip without one; they need no
JAX.  The kernel gives each link a group of lanes sized by C and reads
16 bytes a lane where C and alignment allow, single classes otherwise:
its cases cover both loads, every group size and ragged C.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.bp_route import kernel as tkernel  # noqa: E402
from repro_torch.kernels.bp_route.ops import bp_route_op  # noqa: E402
from repro_torch.kernels.bp_route.ref import bp_route_ref  # noqa: E402

GRID = [(24, 12, 16), (300, 48, 64), (7, 3, 5), (1024, 96, 128)]


def route_inputs(rng, E, C, N, ties=False):
    """Q [N, C] float32, edges [E, 2] int32 without self-loops, cap [E].
    ``ties``: integer backlogs in [0, 3] with duplicated column blocks, so
    most rows hold exact ties of |qm - ql|."""
    if ties:
        base = rng.integers(0, 4, size=(N, -(-C // 3))).astype(np.float32)
        Q = np.tile(base, (1, 3))[:, :C].copy()
    else:
        Q = (rng.random((N, C)) * 100).astype(np.float32)
    m = rng.integers(0, N, size=E)
    l = (m + 1 + rng.integers(0, N - 1, size=E)) % N
    cap = (rng.random(E) * 10).astype(np.float32)
    return Q, np.stack([m, l], 1).astype(np.int32), cap


@pytest.fixture(scope="module")
def J():
    """The JAX reference: the Pallas kernel (interpret mode), its op and
    its oracle."""
    jax = pytest.importorskip("jax")
    from repro.kernels.bp_route.kernel import bp_route_decide
    from repro.kernels.bp_route.ops import bp_route_op as op
    from repro.kernels.bp_route.ref import bp_route_ref as ref
    return types.SimpleNamespace(jnp=jax.numpy, op=op, kernel=bp_route_decide,
                                 ref=ref)


def assert_same(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.int32 or a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.numpy().dtype == b.dtype


def check_against_jax(J, Q, edges, cap, dtype):
    tQ = torch.from_numpy(Q).to(getattr(torch, dtype))
    got = bp_route_op(tQ, torch.from_numpy(edges), torch.from_numpy(cap))
    jQ = J.jnp.asarray(Q).astype(getattr(J.jnp, dtype))
    jE, jc = J.jnp.asarray(edges), J.jnp.asarray(cap)
    qm, ql = jQ[jE[:, 0]], jQ[jE[:, 1]]
    for want in (J.op(jQ, jE, jc), J.kernel(qm, ql, jc, block_e=16),
                 J.ref(qm, ql, jc)):
        assert_same(got, want)
    return got


@pytest.mark.parametrize("E,C,N", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(J, E, C, N, dtype):
    Q, edges, cap = route_inputs(np.random.default_rng(E + C), E, C, N)
    cls, rate, dirn = check_against_jax(J, Q, edges, cap, dtype)
    # the chosen class really is the max |differential backlog|
    Qd = torch.from_numpy(Q).to(getattr(torch, dtype)).float().numpy()
    diff = np.abs(Qd[edges[:, 0]] - Qd[edges[:, 1]])
    np.testing.assert_array_equal(diff[np.arange(E), cls.numpy()],
                                  diff.max(axis=1))


@pytest.mark.parametrize("E,C,N", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ties_and_zero_rows_first_class_wins(J, E, C, N, dtype):
    Q, edges, cap = route_inputs(np.random.default_rng(7), E, C, N,
                                 ties=True)
    Q[0] = Q[1]                                  # link 0 below: all-zero diff
    edges[0] = (0, 1)
    cls, rate, dirn = check_against_jax(J, Q, edges, cap, dtype)
    assert int(cls[0]) == 0 and float(rate[0]) == 0.0 and int(dirn[0]) == -1
    diff = np.abs(Q[edges[:, 0]] - Q[edges[:, 1]])
    first = np.argmax(diff == diff.max(axis=1, keepdims=True), axis=1)
    np.testing.assert_array_equal(cls.numpy(), first)
    assert (rate.numpy() == np.where(diff.max(1) > 0, cap, 0)).all()


def test_zero_differential_gives_no_rate():
    """tests/test_kernels.py::test_bp_route_zero_diff_no_rate, on the port."""
    Q = torch.full((4, 6), 3.0)
    cls, rate, dirn = bp_route_op(Q, torch.tensor([[0, 1], [2, 3]]),
                                  torch.tensor([5.0, 5.0]))
    assert torch.equal(rate, torch.zeros(2))
    assert torch.equal(cls, torch.zeros(2, dtype=torch.int32))
    assert torch.equal(dirn, torch.full((2,), -1, dtype=torch.int32))


def test_wrapper_rejects_bad_inputs():
    qm = torch.zeros((5, 4))
    cap = torch.zeros(5)
    with pytest.raises(TypeError):
        tkernel.bp_route_decide(qm.double(), qm.double(), cap)
    with pytest.raises(TypeError):
        tkernel.bp_route_decide(qm, qm.bfloat16(), cap)
    with pytest.raises(ValueError):
        tkernel.bp_route_decide(qm, qm, torch.zeros(4))
    with pytest.raises(ValueError):
        tkernel.bp_route_decide(qm, torch.zeros((4, 5)).T, cap)
    with pytest.raises(ValueError):
        tkernel.bp_route_decide(torch.zeros((5, 0)), torch.zeros((5, 0)),
                                cap)
    before = tkernel.bp_route_decide.launches
    tkernel.bp_route_decide(qm, qm, cap)
    assert tkernel.bp_route_decide.launches == before  # CPU: no launch


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for E, C, N in GRID + [(4096, 96, 512), (33, 1, 4)]:
        for ties in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                Q, edges, cap = route_inputs(rng, E, C, N, ties=ties)
                e = torch.from_numpy(edges).long()
                Qc = torch.from_numpy(Q).to(dtype).cuda()
                qm, ql = Qc[e[:, 0]], Qc[e[:, 1]]
                capc = torch.from_numpy(cap).cuda()
                before = tkernel.bp_route_decide.launches
                got = tkernel.bp_route_decide(qm, ql, capc)
                want = bp_route_ref(qm, ql, capc)
                torch.cuda.synchronize()
                assert tkernel.bp_route_decide.launches == before + 1
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), (E, C, ties)


@pytest.mark.gpu
def test_cuda_kernel_ragged_and_unaligned_rows():
    """Ragged C (groups of 1 to 32 lanes, rows longer than a warp's pass),
    C that allows 16-byte loads in one dtype and not the other, and rows
    that start off a 16-byte boundary (single-class loads), in float32 and
    bfloat16, random and tie-heavy: bit for bit equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    for C in (1, 2, 3, 4, 5, 8, 12, 16, 17, 31, 64, 95, 96, 97, 128, 129,
              300, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            for ties in (False, True):
                Q, edges, cap = route_inputs(rng, 257, C, 64, ties=ties)
                e = torch.from_numpy(edges).long()
                Qc = torch.from_numpy(Q).to(dtype).cuda()
                capc = torch.from_numpy(cap).cuda()
                for offset in (0, 1):
                    # offset 1: each row starts one element past the
                    # allocation's alignment
                    buf_m = torch.zeros(257 * C + 1, dtype=dtype,
                                        device="cuda")
                    buf_l = torch.zeros_like(buf_m)
                    qm = buf_m[offset:offset + 257 * C].view(257, C)
                    ql = buf_l[offset:offset + 257 * C].view(257, C)
                    qm.copy_(Qc[e[:, 0]])
                    ql.copy_(Qc[e[:, 1]])
                    got = tkernel.bp_route_decide(qm, ql, capc)
                    want = bp_route_ref(qm, ql, capc)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32),
                                           b.view(torch.int32)), (
                            C, dtype, ties, offset)
