"""A reduced training step on the card (`gpu`-marked: skipped without a
CUDA device; needs no JAX, so it runs on the card's machine).

granite-moe-1b-a400m reduced (2 layers, head dim 16: float32 attention
runs the CUDA-core flash kernel), float32, through both autograd
Functions: every leaf's gradient finite and non-zero, the kernels launched
once per layer (twice under full remat, whose blocks run again in the
backward), and the loss within 1e-5 and every gradient within 1e-4
(Frobenius, relative) of the same step on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.bp_topk import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_train_step_on_the_card_reaches_every_leaf(remat):
    """See the module docstring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tcfg = tconfigs.reduced(tconfigs.get_config("granite-moe-1b-a400m"))
    rcfg = tconfigs.RunConfig(model=tcfg, shape=tconfigs.SHAPES["train_4k"],
                              activ_dtype="float32", remat=remat)
    state, _ = tstep.init_train_state(
        rcfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 17)).astype(np.int32)
    cpu_params = tree_map(lambda p: p.cpu(), state.params)
    before = (fkernel.flash_attention.launches,
              fkernel.flash_attention.launches_sm90,
              tkernel.bp_topk_route.launches)
    loss, _, _, grads = port_value_and_grad_on(tcfg, state.params, toks,
                                                state.router_H, remat)
    torch.cuda.synchronize()
    per = 2 if remat == "full" else 1
    assert (fkernel.flash_attention.launches - before[0],
            fkernel.flash_attention.launches_sm90 - before[1],
            tkernel.bp_topk_route.launches - before[2]) == (
                per * tcfg.n_layers, 0, per * tcfg.n_layers)
    for g in grads:
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0
    cpu = port_value_and_grad_on(tcfg, cpu_params, toks,
                                 state.router_H.cpu(), remat)
    np.testing.assert_allclose(float(loss.detach()), float(cpu[0].detach()),
                               rtol=1e-5)
    for a, b in zip(grads, cpu[3]):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())


def port_value_and_grad_on(tcfg, params, toks, H, remat):
    dev = tree_leaves(params)[0].device
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss, (H_out, metrics) = get_model(tcfg).loss(
        leaves, {"tokens": torch.from_numpy(toks).to(dev)},
        activ_dtype=torch.float32, remat=remat, router_H=H)
    return loss, H_out, metrics, torch.autograd.grad(loss,
                                                     tree_leaves(leaves))
