"""The trace simulator on the card (no JAX here: the card's machine has
none).  Skips without a CUDA device."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import STATE_FIELDS  # noqa: E402
from repro_torch.core import PolicyConfig, paper_grid_problem  # noqa: E402
from repro_torch.kernels.bp_slot import kernel as K  # noqa: E402
from repro_torch.sim import build_step, make_trace_runner, workload  # noqa: E402


@pytest.mark.gpu
def test_graphed_runner_equals_the_eager_loop_on_the_card():
    """On the card the runner replays one captured graph per shape; the
    eager loop of the same slot step on the same arrivals and bits gives
    every trace and the final state bit for bit, and a second problem of
    the same shape replays the graph without a new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lams = [5.0, 8.0, 10.5]
    T = 2 * 64 + 17
    for policy in ("pi3", "pi3bar"):
        for C in (2.0, 3.0):
            cfg = PolicyConfig(name=policy, eps_b=0.01)
            pp, _ = build_step(paper_grid_problem(C=C), cfg, "cuda")
            arr = workload.poisson_arrivals(lams, T, seed=7, device="cuda")
            run = make_trace_runner(pp, cfg)
            before = K.slot_step_fused.launches + K.slot_step_fused.replayed
            graphed = run(arr, 7)
            torch.cuda.synchronize()
            launched = (K.slot_step_fused.launches +
                        K.slot_step_fused.replayed - before)
            assert launched == T
            assert run.launch.n_captures == 1
            eager = run.eager(arr, 7)
            for g, e in zip(graphed[1:], eager[1:]):
                assert torch.equal(g, e)
            for k in STATE_FIELDS:
                assert torch.equal(getattr(graphed.final_state, k),
                                   getattr(eager.final_state, k)), k
