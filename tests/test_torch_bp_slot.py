"""Parity of the port's slot kernels (bp_slot) with the reference.

On the CPU the port's wrappers run their plain PyTorch versions; these
must equal the JAX package's Pallas kernels (interpret mode) and its
`ref.py` bit for bit: indices, `dmax` and `Z`.  The fused slot step
(`slot_step_fused`, `csrc/bp_slot_step.cu`) is held here to a numpy
emulation of the kernel's per-sim order, and its wrapper to its plain
version.  The `gpu`-marked tests hold the CUDA kernels to the plain
versions on the card and skip without one; they need no JAX, so they run
on a card machine without it.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core.queues import NetState  # noqa: E402
from repro_torch.fleet.batching import PadDims, pad_problem  # noqa: E402
from repro_torch.fleet.scenarios import get_scenario  # noqa: E402
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
            " torch.ones(1, 1, dtype=torch.int32)); print(int(b[0, 0]));"
            "from repro_torch.core.policies import PolicyConfig, slot_step;"
            "from repro_torch.core.queues import init_state;"
            "from repro_torch.fleet.batching import PadDims, pad_problem;"
            "from repro_torch.fleet.scenarios import get_scenario;"
            "g = get_scenario('paper_grid').build(0);"
            "pp = pad_problem(g, PadDims.of([g]), 'cpu');"
            "s, m = slot_step(pp, PolicyConfig('pi3bar'), init_state(pp),"
            " torch.full((1,), 2.0));"
            "print(kernel.slot_step_fused.launches, float(s.Q.sum()))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "4.0"]


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


# ---------------------------------------------------------------------------
# The fused slot step (slot_step_fused, csrc/bp_slot_step.cu)
# ---------------------------------------------------------------------------

#: (scenario, policy, pad_extra, fail_pattern, pairing): every policy, both
#: pairings, padded nodes/links/comp nodes, failed comp nodes, wireless.
#: tests/test_torch_policies.py runs the same rows against the JAX package.
CASES = [
    ("paper_grid", "pi3", 2, 5, "fifo"),
    ("paper_grid", "pi3_reg", 0, 0, "bound"),
    ("paper_grid", "pi1", 1, 0, "fifo"),
    ("paper_grid", "pi1p", 0, 0, "fifo"),
    ("ring", "pi3bar", 3, 3, "fifo"),
    ("ring", "pi2", 1, 0, "bound"),
    ("fat_tree", "pi3", 1, 6, "fifo"),
    ("wireless_grid", "pi3", 0, 0, "fifo"),
]


def random_state(rng, N, NC):
    """A feasible random queue state (dummy content <= processed queue)."""
    Q = (rng.random((N, 3, NC)) * 6).astype(np.float32)
    Q[rng.random((N, 3, NC)) < 0.3] = 0.0
    return dict(
        Q=Q, Ddum=(Q[:, 0, :] * rng.random((N, NC)) * 0.5).astype(np.float32),
        X=(rng.random((NC, 2)) * 4).astype(np.float32),
        Y=(rng.random(NC) * 2).astype(np.float32),
        H=(rng.random(NC) * 3).astype(np.float32),
        cum_arr=(10 + rng.random((NC, 2)) * 5).astype(np.float32),
        cum_comb=(rng.random(NC) * 8).astype(np.float32),
        delivered=np.float32(50.0), delivered_useful=np.float32(45.0),
        delivered_c=np.float32(0.0), delivered_useful_c=np.float32(0.0))


def case_inputs(row, B=1, seed=0, device="cpu"):
    """A CASES row as the port builds it, without JAX: the padded problem
    (B copies; comp nodes failed as in the row's pattern, through
    `with_capacity_scales`), B random states, the policy config."""
    scen, policy, pad_extra, fail, pairing = row
    problem = get_scenario(scen).build(0)
    dims = PadDims(problem.graph.n_nodes + pad_extra,
                   problem.graph.n_edges + 2 * pad_extra,
                   problem.n_comp + pad_extra)
    pp = pad_problem(problem, dims, "cpu")
    pp = pp.replace(**{k: getattr(pp, k).expand(B, *getattr(pp, k).shape[1:])
                       .contiguous() for k in tref.PROBLEM_LEAVES})
    comp_scale = torch.tensor(
        [[0.0 if (fail >> (i % 3)) & 1 and i > 0 else 1.0
          for i in range(dims.n_comp)]] * B)
    pp = pp.with_capacity_scales(torch.ones(B, dims.n_edges), comp_scale)
    rng = np.random.default_rng(seed)
    states = [random_state(rng, dims.n_nodes, dims.n_comp) for _ in range(B)]
    state = NetState(**{k: torch.from_numpy(np.stack(
        [np.asarray(st[k], np.float32) for st in states]))
        for k in tref.STATE_LEAVES})
    cfg = tpol.PolicyConfig(name=policy, eps_b=0.05, pairing=pairing,
                            threshold=1.5,
                            wireless=get_scenario(scen).wireless)
    return pp.to(device), NetState(**{
        k: getattr(state, k).to(device) for k in tref.STATE_LEAVES}), cfg


def slot_noise(rng, B, NC, eps_b=0.05):
    """(arrivals [B], regulator draws [B, NC], eps_b [B]) of one slot."""
    arr = torch.from_numpy((rng.random(B) * 4).astype(np.float32))
    draws = torch.from_numpy((rng.random((B, NC)) < eps_b).astype(np.float32))
    return arr, draws, torch.full((B,), eps_b)


F = np.float32
TINY = F(1e-20)


def warp_sum(vals):
    """`bp_warp_sum`: lane j adds vals[j], vals[j+32], ... from 0 in order,
    then a butterfly over the 32 lanes."""
    lanes = [F(0)] * 32
    for i, v in enumerate(vals):
        lanes[i % 32] = F(lanes[i % 32] + v)
    for o in (16, 8, 4, 2, 1):
        lanes = [F(lanes[j] + lanes[j ^ o]) for j in range(32)]
    return lanes[0]


def kahan(s, c, x):
    y = F(x - c)
    t = F(s + y)
    return t, F(F(t - s) - y)


def emulate_sim(st, pr, arr, draws, eps, cfg):
    """One sim's slot as `bp_slot_step_kernel` computes it, phase by phase,
    in float32: per-index scatters in update-list order, the greedy
    matching by rank, reductions in the kernel's order.  Returns (new state
    dict, n_star, Z)."""
    N, _, NC = st["Q"].shape
    C, E = 3 * NC, len(pr["edge_cap"])
    Q, D = st["Q"].reshape(-1).copy(), st["Ddum"].reshape(-1).copy()
    X, CA = st["X"].reshape(-1).copy(), st["cum_arr"].reshape(-1).copy()
    Y, H, CC = st["Y"].copy(), st["H"].copy(), st["cum_comb"].copy()
    comp, caps, cmask = pr["comp_nodes"], pr["comp_caps"], pr["comp_mask"]
    s1, s2, dest = int(pr["s1"]), int(pr["s2"]), int(pr["dest"])

    # (i) n*, admission, H
    ns = cfg.fixed_node
    if cfg.load_balance:
        one_eps, best_s, ns = F(F(1) + eps), F(np.inf), 0
        for n in range(NC):
            sc = F(F(F(F(one_eps * Q[(comp[n] * 3) * NC + n])
                       + Q[(s1 * 3 + 1) * NC + n])
                     + Q[(s2 * 3 + 2) * NC + n]) + H[n])
            if not cmask[n] > 0:
                sc = F(np.inf)
            if n == 0:
                best_s = sc
            elif sc < best_s:
                best_s, ns = sc, n
    asg = np.zeros(NC, np.float32)
    asg[ns] = arr
    at = comp[ns]
    k1, k2 = (s1 * 3 + 1) * NC + ns, (s2 * 3 + 2) * NC + ns
    Q[k1] = F(Q[k1] + (F(0) if at == s1 else arr))
    Q[k2] = F(Q[k2] + (F(0) if at == s2 else arr))
    for j, direct in ((ns * 2, at == s1), (ns * 2 + 1, at == s2)):
        X[j] = F(X[j] + (arr if direct else F(0)))
        CA[j] = F(CA[j] + (arr if direct else F(0)))
    for n in range(NC):
        H[n] = max(F(F(H[n] + asg[n]) - caps[n]), F(0))

    # (ii) routing: B1, allocation, matching, caps, scatters
    Qf = Q.reshape(N, C)
    m, l = pr["edges"][:, 0], pr["edges"][:, 1]
    alloc, w = np.zeros(E, np.float32), np.zeros(E, np.float32)
    bi, bn, src, dst = (np.zeros(E, int) for _ in range(4))
    for e in range(E):
        best, bd = 0, F(Qf[m[e], 0] - Qf[l[e], 0])
        for c in range(1, C):
            d = F(Qf[m[e], c] - Qf[l[e], c])
            if abs(d) > abs(bd):
                best, bd = c, d
        bi[e], bn[e] = best // NC, best % NC
        cap, ad = pr["edge_cap"][e], abs(bd)
        alloc[e] = F(F(cap * (F(1) if ad > 0 else F(0))) * pr["edge_mask"][e])
        w[e] = F(F(ad * (F(1) if cap > 0 else F(0))) * pr["edge_mask"][e])
        src[e], dst[e] = (m[e], l[e]) if bd > 0 else (l[e], m[e])
    if cfg.wireless:
        rank = [sum((w[j] > w[e]) or (w[j] == w[e] and j < e)
                    for j in range(E)) for e in range(E)]
        order = np.argsort(rank)
        assert sorted(rank) == list(range(E))
        used = np.zeros(N, bool)
        for e in order:
            ok = not used[m[e]] and not used[l[e]] and w[e] > 0
            if ok:
                used[m[e]] = used[l[e]] = True
            alloc[e] = F(alloc[e] * (F(1) if ok else F(0)))
    ksrc = (src * 3 + bi) * NC + bn
    kdst = (dst * 3 + bi) * NC + bn
    tot = np.zeros(N * C, np.float32)
    for e in range(E):                  # per index: its updates in order
        tot[ksrc[e]] = F(tot[ksrc[e]] + alloc[e])
    act, moved = np.zeros(E, np.float32), np.zeros(E, np.float32)
    tonet, mnet = np.zeros(E, np.float32), np.zeros(E, np.float32)
    tox, proc = np.zeros(E, np.float32), np.zeros(E, bool)
    for e in range(E):
        q, t = Q[ksrc[e]], tot[ksrc[e]]
        scale = F(q / max(t, TINY)) if t > q else F(1)
        act[e] = F(alloc[e] * scale)
        q0, ds = Q[(src[e] * 3) * NC + bn[e]], D[src[e] * NC + bn[e]]
        frac = F(ds / max(q0, TINY)) if q0 > 0 else F(0)
        moved[e] = F(F(act[e] * frac) * (F(1) if bi[e] == 0 else F(0)))
        snk = bool(pr["sink"].reshape(-1)[kdst[e]])
        tonet[e] = F(act[e] * (F(0) if snk else F(1)))
        mnet[e] = F(moved[e] * (F(0) if snk else F(1)))
        tox[e] = F(act[e] * (F(1) if snk and bi[e] >= 1 else F(0)))
        proc[e] = snk and bi[e] == 0
    for k, v in [(ksrc[e], -act[e]) for e in range(E)] + \
            [(kdst[e], tonet[e]) for e in range(E)]:
        Q[k] = F(Q[k] + v)
    for k, v in [(src[e] * NC + bn[e], -moved[e]) for e in range(E)] + \
            [(dst[e] * NC + bn[e], mnet[e]) for e in range(E)]:
        D[k] = F(D[k] + v)
    for e in range(E):
        j = bn[e] * 2 + max(bi[e] - 1, 0)
        X[j], CA[j] = F(X[j] + tox[e]), F(CA[j] + tox[e])
    dlv = warp_sum([F(act[e] * F(proc[e])) for e in range(E)])
    dlvu = warp_sum([F(F(act[e] - moved[e]) * F(proc[e])) for e in range(E)])

    # (iii) computation: Z, regulator, injection or delivery
    Z = np.zeros(NC, np.float32)
    for n in range(NC):
        xnet = F(0)
        if cfg.pairing == "bound":
            r1 = r2 = F(0)
            for k in range(N):
                r1 = F(r1 + Q[(k * 3 + 1) * NC + n])
                r2 = F(r2 + Q[(k * 3 + 2) * NC + n])
            xnet = F(r1 + r2)
        x1, x2, capm = X[2 * n], X[2 * n + 1], F(caps[n] * cmask[n])
        if cfg.pairing == "bound":
            P = F(F(F(x1 + x2) - xnet) / F(2))
        else:
            P = F(min(CA[2 * n], CA[2 * n + 1]) - CC[n])
        P = min(max(P, F(0)), min(x1, x2))
        if cfg.thresholded:
            bar = F(F(F(2) * capm) + F(cfg.threshold))
            Z[n] = min(capm if F(x1 + x2) >= bar else F(0), P)
        else:
            Z[n] = min(P, capm)
        X[2 * n], X[2 * n + 1] = F(x1 - Z[n]), F(x2 - Z[n])
        CC[n] = F(CC[n] + Z[n])
    d2, du2 = [], []
    for n in range(NC):
        amount, dummy = Z[n], F(0)
        if cfg.use_regulator:
            yz = F(Y[n] + Z[n])
            amount = F(asg[n] * F(F(1) + draws[n]))
            useful = min(yz, amount)
            dummy, Y[n] = F(amount - useful), F(yz - useful)
        keep = F(0) if comp[n] == dest else F(1)
        k = (comp[n] * 3) * NC + n
        Q[k] = F(Q[k] + F(amount * keep))
        D[comp[n] * NC + n] = F(D[comp[n] * NC + n] + F(dummy * keep))
        d2.append(F(amount * F(F(1) - keep)))
        du2.append(F(F(amount - dummy) * F(F(1) - keep)))
    d, dc = kahan(st["delivered"], st["delivered_c"], dlv)
    du, duc = kahan(st["delivered_useful"], st["delivered_useful_c"], dlvu)
    sd = sdu = F(0)
    for n in range(NC):
        sd, sdu = F(sd + d2[n]), F(sdu + du2[n])
    d, dc = kahan(d, dc, sd)
    du, duc = kahan(du, duc, sdu)
    new = dict(Q=Q.reshape(N, 3, NC), Ddum=D.reshape(N, NC),
               X=X.reshape(NC, 2), Y=Y, H=H, cum_arr=CA.reshape(NC, 2),
               cum_comb=CC, delivered=d, delivered_useful=du,
               delivered_c=dc, delivered_useful_c=duc)
    return new, ns, Z


def emulate(pp, state, arrivals, draws, eps_b, cfg):
    """`emulate_sim` over every sim of a CPU batch: (state, n_star, Z)."""
    st = {k: getattr(state, k).numpy() for k in tref.STATE_LEAVES}
    pr = {k: getattr(pp, k).numpy() for k in tref.PROBLEM_LEAVES}
    out = [emulate_sim({k: v[b] for k, v in st.items()},
                       {k: v[b] for k, v in pr.items()}, F(arrivals[b]),
                       draws[b].numpy(), F(eps_b[b]), cfg)
           for b in range(state.Q.shape[0])]
    new = {k: np.stack([o[0][k] for o in out]) for k in tref.STATE_LEAVES}
    return new, np.array([o[1] for o in out]), np.stack([o[2] for o in out])


def plain_with_z(pp, cfg, state, arrivals, draws, eps_b, **kw):
    """`slot_step_ref` and the Z its second B2 call decided."""
    seen = []

    def balance(*a, **k):
        out = tkernel.comp_balance_decide(*a, **k)
        seen.append(out[0])
        return out
    new, m = tref.slot_step_plain(
        {k: getattr(state, k) for k in tref.STATE_LEAVES},
        {k: getattr(pp, k) for k in tref.PROBLEM_LEAVES}, arrivals,
        draws if cfg.use_regulator else None, eps_b,
        load_balance=cfg.load_balance, fixed_node=cfg.fixed_node,
        regulated=cfg.use_regulator, pairing=cfg.pairing,
        thresholded=cfg.thresholded, threshold=cfg.threshold,
        wireless=cfg.wireless, route=tkernel.slot_route_decide,
        balance=balance)
    assert torch.equal(seen[-1], m["Z"])
    return NetState(**new), m


FLOAT_LEAVES_FED_BY_SUMS = ("delivered", "delivered_useful", "delivered_c",
                            "delivered_useful_c")


@pytest.mark.parametrize("row", CASES, ids=[f"{r[0]}-{r[1]}-{r[4]}"
                                            for r in CASES])
def test_kernel_emulation_matches_plain_slot_step(row):
    """The kernel's per-sim order, emulated, against `slot_step_ref` on the
    CPU over 8 teacher-forced slots (each from the plain version's carry),
    B=16 sims.  n*, Z and every scattered leaf bit-identical, with either
    pairing (bound pairing's x_net is a serial sum over nodes on both
    sides); the delivery counters (fed by sums over links, in a warp's
    tree order in the kernel) within 1e-6, a Kahan pair as its compensated
    value."""
    pp, state, cfg = case_inputs(row, B=16, seed=len(row[0]))
    rng = np.random.default_rng(7)
    for t in range(8):
        arr, draws, eps = slot_noise(rng, 16, pp.n_comp)
        ref, m = plain_with_z(pp, cfg, state, arr, draws, eps)
        emu, ns, Z = emulate(pp, state, arr, draws, eps, cfg)
        np.testing.assert_array_equal(ns, m["n_star"].numpy())
        for k in tref.STATE_LEAVES + ("Z",):
            got = Z if k == "Z" else emu[k]
            want = m["Z"].numpy() if k == "Z" else getattr(ref, k).numpy()
            if k in ("delivered_c", "delivered_useful_c"):
                continue
            if k in FLOAT_LEAVES_FED_BY_SUMS:
                comp = k + "_c"
                got = got.astype(np.float64) - emu[comp]
                want = want.astype(np.float64) - getattr(ref, comp).numpy()
            if k not in FLOAT_LEAVES_FED_BY_SUMS:
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"slot {t}: {k}")
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"slot {t}: {k}")
        state = ref


def test_wireless_ties_keep_the_stable_order():
    """Links of equal weight are matched in index order: with backlog at one
    node only, every link at that node has the same |differential|, and
    the greedy matching (node-exclusive) may take one.  The plain version
    (stable argsort) and the kernel's rank order both take the lowest-index
    link; the kernel emulation agrees bit for bit."""
    pp, state, cfg = case_inputs(("wireless_grid", "pi3bar", 0, 0, "fifo"))
    edges = pp.edges[0].numpy()
    comp0 = int(pp.comp_nodes[0, 0])
    deg = np.bincount(edges.reshape(-1), minlength=pp.n_nodes)
    nbrs = {a: [int(e[1] if e[0] == a else e[0]) for e in edges if a in e]
            for a in range(pp.n_nodes)}
    a = next(a for a in range(pp.n_nodes)
             if deg[a] >= 3 and comp0 not in nbrs[a] and a != comp0)
    incident = [e for e in range(len(edges)) if a in edges[e]]
    Q = torch.zeros_like(state.Q)
    Q[0, a, 1, 0] = 5.0
    zeros = {k: torch.zeros_like(getattr(state, k))
             for k in tref.STATE_LEAVES}
    state = NetState(**{**zeros, "Q": Q})
    arr, draws, eps = torch.zeros(1), torch.zeros(1, pp.n_comp), \
        torch.full((1,), 0.05)
    ref, m = plain_with_z(pp, cfg, state, arr, draws, eps)
    emu, _, _ = emulate(pp, state, arr, draws, eps, cfg)
    for k in tref.STATE_LEAVES:
        np.testing.assert_array_equal(_bits(emu[k]),
                                      _bits(getattr(ref, k).numpy()), err_msg=k)
    first = edges[incident[0]]
    got = {b: float(ref.Q[0, b, 1, 0]) for b in nbrs[a]}
    moved_to = int(first[1] if first[0] == a else first[0])
    assert got[moved_to] == pytest.approx(5.0)
    assert all(v == 0.0 for b, v in got.items() if b != moved_to)
    assert float(m["routed"][0]) == pytest.approx(5.0)


@pytest.mark.parametrize("row", CASES, ids=[f"{r[0]}-{r[1]}-{r[4]}"
                                            for r in CASES])
def test_fused_wrapper_on_cpu_equals_plain(row):
    """`slot_step` (through `slot_step_fused`) on CPU tensors equals
    `slot_step_ref` bit for bit, metrics included, and counts no launch."""
    pp, state, cfg = case_inputs(row, B=2, seed=3)
    rng = np.random.default_rng(1)
    before = tkernel.slot_step_fused.launches
    for _ in range(4):
        arr, draws, eps = slot_noise(rng, 2, pp.n_comp)
        a, ma = tpol.slot_step(pp, cfg, state, arr, draws, eps)
        b, mb = tpol.slot_step_ref(pp, cfg, state, arr, draws, eps)
        assert list(ma) == list(mb)
        for k in tref.STATE_LEAVES:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        state = a
    assert tkernel.slot_step_fused.launches == before


def test_fused_wrapper_checks_inputs():
    pp, state, cfg = case_inputs(CASES[1], B=2)
    st = {k: getattr(state, k) for k in tref.STATE_LEAVES}
    pr = {k: getattr(pp, k) for k in tref.PROBLEM_LEAVES}
    arr, draws, eps = slot_noise(np.random.default_rng(0), 2, pp.n_comp)
    flags = dict(load_balance=True, fixed_node=0, regulated=True,
                 pairing="bound", thresholded=False, threshold=0.0,
                 wireless=False)

    def call(st=st, pr=pr, arr=arr, draws=draws, eps=eps, **kw):
        return tkernel.slot_step_fused(st, pr, arr, draws, eps,
                                       **{**flags, **kw})
    call()
    with pytest.raises(TypeError):
        call(st={**st, "Q": st["Q"].double()})
    with pytest.raises(TypeError):
        call(pr={**pr, "edges": pr["edges"].long()})
    with pytest.raises(TypeError):
        call(arr=arr.double())
    with pytest.raises(ValueError):
        call(st={**st, "Ddum": st["Ddum"][:, :-1].contiguous()})
    with pytest.raises(ValueError):
        call(st={**st, "Q": st["Q"][..., :1, :]})
    with pytest.raises(ValueError):
        call(pr={**pr, "edge_cap": pr["edge_cap"][:1]})
    with pytest.raises(ValueError):
        call(eps=eps[:1])
    with pytest.raises(ValueError):                     # not contiguous
        call(st={**st, "X": st["X"].transpose(1, 2).contiguous()
                 .transpose(1, 2)})
    with pytest.raises(ValueError):
        call(draws=None)
    with pytest.raises(ValueError):
        call(pairing="lifo")
    with pytest.raises(ValueError):
        call(load_balance=False, fixed_node=pp.n_comp)
    call(draws=None, regulated=False)           # draws unread: may be None


def _on(state, dev):
    return NetState(**{k: getattr(state, k).to(dev)
                       for k in tref.STATE_LEAVES})


@pytest.mark.gpu
@pytest.mark.parametrize("row", CASES, ids=[f"{r[0]}-{r[1]}-{r[4]}"
                                            for r in CASES])
def test_cuda_fused_slot_step_matches_plain(row):
    """The fused kernel against `slot_step_ref` on the card and on the CPU,
    8 slots, each from the CPU plain version's carry, B=8.  The decisions
    n* and Z equal everywhere.  Against the CPU, whose scatter order the
    kernel keeps: with fifo pairing every scattered leaf bit-identical,
    and everything within 1e-6 (sums run in another order).  Against the
    card's plain version, whose sorted scatter-adds round otherwise:
    within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pp, state, cfg = case_inputs(row, B=8, seed=11)
    ppc = pp.to("cuda")
    rng = np.random.default_rng(5)
    for t in range(8):
        arr, draws, eps = slot_noise(rng, 8, pp.n_comp)
        cpu, mc = plain_with_z(pp, cfg, state, arr, draws, eps)
        card, md = plain_with_z(ppc, cfg, _on(state, "cuda"), arr.cuda(),
                                draws.cuda(), eps.cuda())
        new, mf = tkernel.slot_step_fused(
            {k: getattr(state, k).cuda() for k in tref.STATE_LEAVES},
            {k: getattr(ppc, k) for k in tref.PROBLEM_LEAVES}, arr.cuda(),
            draws.cuda(), eps.cuda(), load_balance=cfg.load_balance,
            fixed_node=cfg.fixed_node, regulated=cfg.use_regulator,
            pairing=cfg.pairing, thresholded=cfg.thresholded,
            threshold=cfg.threshold, wireless=cfg.wireless)
        torch.cuda.synchronize()
        assert torch.equal(mf["n_star"].cpu(), mc["n_star"])
        assert torch.equal(mf["n_star"], md["n_star"])
        for want in (mc["Z"], md["Z"].cpu()):
            assert torch.equal(mf["Z"].cpu().view(torch.int32),
                               want.view(torch.int32)), t
        pairs = [(k, new[k].cpu(), getattr(cpu, k), getattr(card, k).cpu())
                 for k in tref.STATE_LEAVES if not k.endswith("_c")]
        pairs += [(k, mf[k].cpu(), mc[k], md[k].cpu())
                  for k in ("Z", "total_queue", "routed", "computed")]
        for k, got, want_cpu, want_card in pairs:
            if cfg.pairing == "fifo" and k not in FLOAT_LEAVES_FED_BY_SUMS \
                    and k not in ("total_queue", "routed", "computed"):
                assert torch.equal(got.view(torch.int32),
                                   want_cpu.view(torch.int32)), (t, k)
            torch.testing.assert_close(got, want_cpu, rtol=1e-6, atol=1e-6,
                                       msg=f"slot {t}: {k} vs CPU")
            torch.testing.assert_close(got, want_card, rtol=1e-5, atol=1e-5,
                                       msg=f"slot {t}: {k} vs card")
        state = cpu


@pytest.mark.gpu
def test_cuda_fused_sim_alone_equals_in_batch():
    """A sim's slot does not depend on its batch: sim 37 of 64 alone and in
    the batch give the same bits, over 4 slots of a regulated,
    bound-pairing case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pp, state, cfg = case_inputs(CASES[1], B=64, seed=2)
    pp, state = pp.to("cuda"), _on(state, "cuda")
    k = 37
    one_pp = pp.replace(**{n: getattr(pp, n)[k:k + 1].contiguous()
                           for n in tref.PROBLEM_LEAVES})
    one = NetState(**{n: getattr(state, n)[k:k + 1].contiguous()
                      for n in tref.STATE_LEAVES})
    rng = np.random.default_rng(4)
    for _ in range(4):
        arr, draws, eps = (x.cuda() for x in slot_noise(rng, 64, pp.n_comp))
        state, m = tpol.slot_step(pp, cfg, state, arr, draws, eps)
        one, m1 = tpol.slot_step(one_pp, cfg, one, arr[k:k + 1].contiguous(),
                                 draws[k:k + 1].contiguous(),
                                 eps[k:k + 1].contiguous())
        for n in tref.STATE_LEAVES:
            assert torch.equal(getattr(state, n)[k:k + 1], getattr(one, n)), n
        for n in m:
            assert torch.equal(m[n][k:k + 1], m1[n]), n


@pytest.mark.gpu
def test_cuda_slot_step_launches_the_fused_kernel_once():
    """`slot_step` on CUDA tensors launches the fused kernel once per call
    and B1/B2 not at all; `slot_step_ref` launches B1 once and B2 twice
    (pi3) and the fused kernel not at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pp, state, cfg = case_inputs(CASES[0], B=4, seed=1)
    pp, state = pp.to("cuda"), _on(state, "cuda")
    arr, draws, eps = (x.cuda() for x in
                       slot_noise(np.random.default_rng(0), 4, pp.n_comp))
    K = tkernel

    def counts():
        return (K.slot_step_fused.launches, K.slot_route_decide.launches,
                K.comp_balance_decide.launches)
    before = counts()
    for _ in range(3):
        state, _ = tpol.slot_step(pp, cfg, state, arr, draws, eps)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 3, before[1], before[2])
    before = counts()
    tpol.slot_step_ref(pp, cfg, state, arr, draws, eps)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2] + 2)
