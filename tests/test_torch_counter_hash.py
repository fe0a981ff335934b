"""The port's counter-based noise kernel (`repro_torch.kernels.counter_hash`).

On the CPU: the wrapper's input checks, its CPU dispatch against the plain
int64 chain and against SplitMix64 in numpy uint64, the draw functions of
`sim.workload` on it, and the launch accounting of `CapturedSlots`.  The
`gpu`-marked tests hold the CUDA kernel to the plain chain bit for bit on
the card, eagerly and inside a captured CUDA graph, and count its launches
on the fleet's path; they skip without a card and need no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fleet.capture import CapturedSlots  # noqa: E402
from repro_torch.kernels.counter_hash import kernel as K  # noqa: E402
from repro_torch.kernels.counter_hash import ref as R  # noqa: E402
from repro_torch.sim import workload  # noqa: E402

SITES = tuple(range(1, 8))
#: Slot counters at the edges the int32 carry can hold.
T_VALUES = (0, 1, 4095, 2 ** 31 - 2)
#: Seeds: zero, small, negative, and +-2^62.
SEED_VALUES = (0, 5, -1, -(2 ** 62), 2 ** 62, 3 * 2_147_483_701 + 2)
#: (B, n) of the cells' draws: the trace simulator's regulator (9, 4), the
#: fleet's buckets at their widths, the 1,512-lane batch padded to the
#: atlas's widest bucket (arrivals, link chain, comp chain and regulator),
#: and the [2,500] arrival stream of `poisson_arrivals`.
SHAPES = ((9, 4), (168, 1), (168, 3), (504, 4), (504, 14), (504, 24),
          (168, 51), (1512, 1), (1512, 4), (1512, 51), (2500, 1))
#: A draw within 127 elements of the wrapper's limit, 2^31 - 2 elements:
#: the last block's thread indices pass INT_MAX.
LIMIT_SHAPE = (2 * 151 * 331, 9 * 7 * 11 * 31)


def inputs(B: int, t_dtype, device="cpu", seed: int = 0):
    """seed [B] int64 with every SEED_VALUES entry in its first rows, t [B]
    with every T_VALUES entry, eps [B] float32 in [0, 1) with 0 and 1."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, B,
                                      dtype=np.int64))
    t = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, B, dtype=np.int64))
    k = min(B, len(SEED_VALUES))
    s[:k] = torch.tensor(SEED_VALUES[:k])
    k = min(B, len(T_VALUES))
    t[-k:] = torch.tensor(T_VALUES[:k])
    eps = torch.from_numpy(rng.random(B, dtype=np.float32))
    eps[0] = 0.0
    eps[-1] = 1.0
    return (s.to(device), t.to(t_dtype).to(device), eps.to(device))


def splitmix_np(seed, t, site, n):
    """SplitMix64 of (seed, t, site, index) in numpy uint64: [B, n]."""
    def mix(z):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))
    g = np.uint64(0x9E3779B97F4A7C15)
    s = np.asarray(seed, np.int64).view(np.uint64)
    tt = np.asarray(t, np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        base = mix(mix(s * g + np.uint64(site)) + (tt + np.uint64(1)) * g)
        idx = np.arange(1, n + 1, dtype=np.uint64)
        return mix(base[:, None] + idx[None] * g)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_moved_chain_is_reachable_from_workload():
    assert workload.mix64 is R.mix64
    assert workload.random_bits is R.random_bits
    assert workload._srl is R._srl


@pytest.mark.parametrize("t_dtype", (torch.int32, torch.int64))
def test_cpu_dispatch_is_the_plain_chain(t_dtype):
    """On CPU tensors every form equals the plain chain and SplitMix64 in
    numpy uint64, and `workload`'s draw functions are those forms."""
    B, n = 37, 5
    seed, t, eps = inputs(B, t_dtype)
    for site in SITES:
        bits = splitmix_np(seed.numpy(), t.long().numpy(), site, n)
        want = {"uniform": (bits >> np.uint64(40)).astype(np.float32)
                * np.float32(2.0 ** -24),
                "uniform64": (bits >> np.uint64(11)).astype(np.float64)
                * 2.0 ** -53}
        want["bernoulli"] = (want["uniform"] < eps.numpy()[:, None]).astype(
            np.float32)
        for form in R.FORMS:
            got = K.counter_hash(seed, t, site, n, form, eps)
            assert got.dtype == K.DTYPES[form] and got.shape == (B, n)
            assert torch.equal(got, R.counter_hash_ref(seed, t, site, n,
                                                       form, eps))
            np.testing.assert_array_equal(got.numpy(), want[form])
        assert torch.equal(workload.uniform(seed, t, site, n),
                           K.counter_hash(seed, t, site, n, "uniform"))
        assert torch.equal(workload.uniform64(seed, t, site, n),
                           K.counter_hash(seed, t, site, n, "uniform64"))
    assert torch.equal(
        workload.regulator_bits(seed, t, eps, n),
        K.counter_hash(seed, t, workload.SITE_REGULATOR, n, "bernoulli", eps))


def test_cpu_calls_launch_nothing():
    seed, t, eps = inputs(4, torch.int64)
    before = (K.counter_hash.launches, K.counter_hash.captured)
    workload.regulator_bits(seed, t, eps, 3)
    assert (K.counter_hash.launches, K.counter_hash.captured) == before


def test_empty_draws():
    seed, t, eps = inputs(3, torch.int32)
    assert K.counter_hash(seed, t, 1, 0, "uniform").shape == (3, 0)
    empty = torch.zeros((0,), dtype=torch.int64)
    assert K.counter_hash(empty, empty, 1, 4, "uniform64").shape == (0, 4)


@pytest.mark.parametrize("case", (
    "seed_int32", "t_float", "eps_float64", "eps_missing", "seed_2d",
    "t_shape", "t_strided", "eps_shape", "form", "site", "n", "elements"))
def test_wrapper_input_checks(case):
    seed, t, eps = inputs(6, torch.int64)
    args = dict(seed=seed, t=t, site=3, n=4, form="bernoulli", eps=eps)
    err = ValueError
    if case == "seed_int32":
        args["seed"], err = seed.to(torch.int32), TypeError
    elif case == "t_float":
        args["t"], err = t.to(torch.float32), TypeError
    elif case == "eps_float64":
        args["eps"], err = eps.double(), TypeError
    elif case == "eps_missing":
        args["eps"] = None
    elif case == "seed_2d":
        args["seed"] = seed[:, None]
    elif case == "t_shape":
        args["t"] = t[:5]
    elif case == "t_strided":
        args["t"] = torch.stack([t, t], 1)[:, 0]
    elif case == "eps_shape":
        args["eps"] = eps[None]
    elif case == "form":
        args["form"] = "normal"
    elif case == "site":
        args["site"] = -1
    elif case == "n":
        args["n"] = -1
    elif case == "elements":                # B * n = MAX_ELEMENTS + 1
        args["seed"], args["t"], args["eps"] = inputs(2 ** 16, torch.int64)
        args["n"] = 2 ** 15
    with pytest.raises(err):
        K.counter_hash(**args)


def test_replays_count_the_captured_hashes():
    """A replay of a captured block adds its counter-hash launches to
    ``counter_hash.replayed``, as it adds the fused slot steps."""
    class Graph:
        def replay(self):
            pass

    block = CapturedSlots(64)
    block.graph = Graph()
    block.captured = {"slot_step_fused": 64, "counter_hash": 128}
    before = K.counter_hash.replayed
    block.replay(3)
    assert K.counter_hash.replayed - before == 3 * 128
    assert block.replays == 3


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32 if a.dtype == torch.float32 else torch.int64),
        b.view(torch.int32 if b.dtype == torch.float32 else torch.int64))


@pytest.mark.gpu
def test_kernel_equals_the_plain_chain_on_the_card(cuda):
    """Every site, form and slot-counter dtype at the cells' shapes: the
    kernel's draws equal the plain chain's on the card and on the CPU, bit
    for bit, in one launch each."""
    for i, (B, n) in enumerate(SHAPES):
        for t_dtype in (torch.int32, torch.int64):
            seed, t, eps = inputs(B, t_dtype, cuda, seed=i)
            cpu = [x.cpu() for x in (seed, t, eps)]
            for site in SITES:
                for form in R.FORMS:
                    before = K.counter_hash.launches
                    got = K.counter_hash(seed, t, site, n, form, eps)
                    assert K.counter_hash.launches == before + 1
                    on_card = R.counter_hash_ref(seed, t, site, n, form, eps)
                    on_cpu = K.counter_hash(*cpu[:2], site, n, form, cpu[2])
                    torch.cuda.synchronize()
                    what = (B, n, t_dtype, site, form)
                    assert bits_equal(got, on_card), what
                    assert bits_equal(got.cpu(), on_cpu), what


@pytest.mark.gpu
def test_kernel_at_its_element_limit(cuda):
    """A draw of LIMIT_SHAPE (8.6 GB of float32): its last rows, where the
    thread index passes INT_MAX, equal the plain chain's."""
    B, n = LIMIT_SHAPE
    assert K.MAX_ELEMENTS - 127 <= B * n <= K.MAX_ELEMENTS
    seed, t, _ = inputs(B, torch.int32, cuda)
    got = K.counter_hash(seed, t, 4, n, "uniform")
    want = R.counter_hash_ref(seed[-3:], t[-3:], 4, n, "uniform")
    assert bits_equal(got[-3:], want)
    assert bits_equal(got[:2], R.counter_hash_ref(seed[:2], t[:2], 4, n,
                                                  "uniform"))
    del got
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_captured_draws_equal_the_eager_ones(cuda):
    """A captured block of draws (the regulator's, the fleet's arrivals and
    link chains, with the slot counter advanced in place) replays the eager
    draws bit for bit; ``launches``, ``captured`` and ``replayed`` count
    eager calls, captured calls and the launches of replays."""
    B, NC, E, slots = 504, 4, 24, 8
    seed, t0, eps = inputs(B, torch.int32, cuda)
    t = t0.clone()
    outs = [torch.empty((slots, B, NC), device=cuda),
            torch.empty((slots, B, 1), dtype=torch.float64, device=cuda),
            torch.empty((slots, B, E), device=cuda)]

    def advance():
        for j in range(slots):
            outs[0][j].copy_(workload.regulator_bits(seed, t, eps, NC))
            outs[1][j].copy_(workload.uniform64(seed, t, 1, 1))
            outs[2][j].copy_(workload.uniform(seed, t, 4, E))
            t.add_(1)

    advance()                            # eager: loads the library first
    eager = [o.clone() for o in outs]
    t.copy_(t0)
    block = CapturedSlots(slots)
    launches = K.counter_hash.launches
    replayed = K.counter_hash.replayed
    for o in outs:
        o.zero_()
    block.capture(advance)
    assert K.counter_hash.launches == launches
    assert block.captured["counter_hash"] == 3 * slots
    t.copy_(t0)
    block.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, eager):
        assert bits_equal(a, b)
    block.replay(2)                       # two blocks further on
    torch.cuda.synchronize()
    assert K.counter_hash.replayed - replayed == 3 * 3 * slots
    assert torch.equal(t, t0 + 3 * slots)


@pytest.mark.gpu
def test_fleet_draws_go_through_the_kernel(cuda):
    """A graphed `run_fleet` batch launches the kernel once per draw site a
    slot uses, per batched slot, eager launches and replays together:
    Poisson arrivals and the regulator (2 sites) on the paper grid, plus the
    Gilbert-Elliott link and comp chains (4) on ge_full_grid."""
    from repro_torch.fleet import FleetJob, run_fleet
    for scenario, sites in (("paper_grid", 2), ("ge_full_grid", 4)):
        jobs = [FleetJob(scenario=scenario, policy="pi3_reg", lam=lam,
                         seed=s, eps_b=0.05)
                for lam in (0.5, 1.0) for s in (0, 1)]
        before = K.counter_hash.launches + K.counter_hash.replayed
        res = run_fleet(jobs, T=512, chunk=256, device=cuda)
        torch.cuda.synchronize()
        launched = K.counter_hash.launches + K.counter_hash.replayed - before
        assert res.n_step_compiles == 1
        assert launched == sites * res.slot_steps > 0, scenario
