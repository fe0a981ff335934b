"""The port's train step and launcher against the reference, on the CPU.

One `make_train_step` step runs in both packages from the reference's
initial train state (carried across by `convert.train_state_from_numpy`)
on the same tokens, with the reference's own `make_optimizer` (1.5e-6 at
step 1 of its warmup), in float32: params and moments within atol 1e-5 /
rtol 1e-5, router queues and counts equal.  AdamW's first update is
lr g / (|g| + eps), which turns the rounding of a gradient near 0 into a
change of up to 2 lr, so the update's own arithmetic is held on identical
inputs in `test_torch_optim.py`.  The ports of `tests/test_system.py`'s
training tests assert what those assert.  Helpers come from
`test_torch_train.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402
from test_torch_train import (S, assert_grads_close, configs,  # noqa: E402
                              port_value_and_grad, to_numpy, tokens)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("compression", ["none", "int8_ef", "topk_ef"])
def test_train_step_matches_reference(arch, grad_accum, compression):
    tcfg, jcfg = configs(arch)
    shape = dict(name="t", seq_len=S, global_batch=4, kind="train")
    run = dict(activ_dtype="float32", remat="none", grad_accum=grad_accum,
               grad_compression=compression)
    jrcfg = jconfigs.RunConfig(model=jcfg, shape=jconfigs.ShapeConfig(
        **shape), **run)
    trcfg = tconfigs.RunConfig(model=tcfg, shape=tconfigs.ShapeConfig(
        **shape), **run)
    jstate, _ = jstep.init_train_state(jrcfg, key=jax.random.key(3))
    state = train_state_from_numpy(to_numpy(jstate), "cpu")
    toks = tokens(tcfg, seed=6, batch=4)
    jnew, jm = jstep.make_train_step(jrcfg)(jstate,
                                            {"tokens": jnp.asarray(toks)})
    new, m = tstep.make_train_step(trcfg)(state, {"tokens": toks})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt.count) == int(jnew.opt.count) == 1
    tol = dict(rtol=1e-5, atol=1e-5)
    for ours, ref in ((new.params, jnew.params), (new.opt.m, jnew.opt.m),
                      (new.opt.v, jnew.opt.v)):
        assert_grads_close(tree_leaves(ours), ref, **tol)
    if compression == "none":
        assert new.ef is None and jnew.ef is None
    else:
        grads = step_grads(tcfg, train_state_from_numpy(
            to_numpy(jstate), "cpu").params, toks, None if state.router_H
            is None else np.array(jstate.router_H), grad_accum)
        assert_residuals_close(new, jnew, grads, compression, tol)
    if tcfg.family == "moe":
        np.testing.assert_array_equal(new.router_H.numpy(),
                                      np.asarray(jnew.router_H))


def assert_residuals_close(new, jnew, grads, compression, tol):
    """The error-feedback residuals within ``tol``, except where the
    compressed value sits at a decision boundary: an int8 quantum's
    half-way point (round half to even) or the top-k threshold, where the
    two packages' gradients, equal to rounding, fall on either side.  Such
    an element's residual differs by a quantum (int8) or by the kept value
    (top-k), and its gradient (``grads``, the port's, which the step
    compressed from a zero residual) must lie within 1e-4 of the boundary,
    relative."""
    for err, jerr, g in zip(tree_leaves(new.ef.err),
                            jax.tree_util.tree_leaves(jnew.ef.err), grads):
        g = g.numpy()
        bad = ~np.isclose(err.numpy(), np.asarray(jerr), **tol)
        if compression == "int8_ef":
            q = np.abs(g[bad]) / (max(np.abs(g).max(), 1e-12) / 127.0)
            assert (np.abs(q % 1.0 - 0.5) <= 1e-4 * q).all(), q
        else:
            flat = np.sort(np.abs(g).reshape(-1))[::-1]
            thresh = flat[max(int(flat.size * 0.1), 1) - 1]
            assert (np.abs(np.abs(g[bad]) - thresh) <= 1e-4 * thresh).all()


def step_grads(tcfg, params, toks, H, n_micro):
    """The gradients `make_train_step` feeds the compressor: the mean over
    ``n_micro`` microbatches, H carried from one to the next."""
    total = None
    for mb in np.split(toks, n_micro):
        _, H, _, g = port_value_and_grad(tcfg, params, mb, H)
        H = None if H is None else H.detach().numpy()
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return [t / n_micro for t in total]


def test_train_state_tree_and_checkpoint_round_trip(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    tcfg, _ = configs("granite-moe-1b-a400m")
    rcfg = tconfigs.RunConfig(model=tcfg, shape=tconfigs.SHAPES["train_4k"],
                              activ_dtype="float32",
                              grad_compression="int8_ef")
    state, axes = tstep.init_train_state(
        rcfg, torch.Generator().manual_seed(0), device="cpu")
    assert axes.router_H == (None, None) and axes.opt.count == ()
    assert state.router_H.shape == (tcfg.n_layers, tcfg.n_experts)
    step = tstep.make_train_step(rcfg)
    state, _ = step(state, {"tokens": tokens(tcfg, seed=1)})
    ck = Checkpointer(tmp_path)
    ck.save(int(state.step), state)
    fresh, _ = tstep.init_train_state(rcfg, torch.Generator().manual_seed(9),
                                      device="cpu")
    back = ck.restore(fresh, into=fresh)
    for a, b in zip(tree_leaves(back.params) + tree_leaves(back.opt.m)
                    + tree_leaves(back.ef.err),
                    tree_leaves(state.params) + tree_leaves(state.opt.m)
                    + tree_leaves(state.ef.err)):
        assert torch.equal(a, b)
    assert int(back.step) == int(back.opt.count) == 1
    assert torch.equal(back.router_H, state.router_H)
    # the abstract state: the same tree and axes on the meta device
    meta, meta_axes = tstep.init_train_state(rcfg, abstract=True)
    assert meta_axes == axes
    concrete = ([fresh.step, fresh.opt.count, fresh.router_H]
                + tree_leaves(fresh.params) + tree_leaves(fresh.opt.m)
                + tree_leaves(fresh.opt.v) + tree_leaves(fresh.ef.err))
    abstract = ([meta.step, meta.opt.count, meta.router_H]
                + tree_leaves(meta.params) + tree_leaves(meta.opt.m)
                + tree_leaves(meta.opt.v) + tree_leaves(meta.ef.err))
    assert [(a.shape, a.dtype, a.device.type) for a in abstract] == [
        (b.shape, b.dtype, "meta") for b in concrete]


# ---------------------------------------------------------------------------
# Ports of tests/test_system.py's training tests
# ---------------------------------------------------------------------------

def reference_start(arch, seed, **run):
    """(port config, port RunConfig, the reference's initial train state
    from ``jax.random.key(seed)`` carried across): the reference's tests
    start from that state, so their ports do too (the port's generator
    draws other weights)."""
    tcfg, jcfg = configs(arch)
    run = dict(activ_dtype="float32", remat="none", **run)
    jrcfg = jconfigs.RunConfig(model=jcfg, shape=jconfigs.ShapeConfig(
        "t", 32, 4, "train"), **run)
    jstate, _ = jstep.init_train_state(jrcfg, key=jax.random.key(seed))
    return tcfg, tconfigs.RunConfig(model=tcfg, shape=tconfigs.ShapeConfig(
        "t", 32, 4, "train"), **run), train_state_from_numpy(
        to_numpy(jstate), "cpu")


def test_train_driver_end_to_end(tmp_path):
    """launch.train: loss decreases; crash + --resume continues training."""
    from repro_torch.launch.train import main as train
    common = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4",
              "--seq", "32", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "20", "--log-every", "50", "--device", "cpu"]
    with pytest.raises(SystemExit):
        train(common + ["--steps", "100", "--crash-at", "45"])
    losses = train(common + ["--steps", "100", "--resume"])
    # resumed from step 40 -> 60 steps run; loss dropped vs start of phase 2
    assert len(losses) == 60
    assert np.mean(losses[-10:]) < np.mean(losses[:5])


def test_moe_training_with_backpressure_router():
    """A MoE arch trains end to end with the paper's router in the loop and
    the H queues stay bounded (drained by capacity)."""
    cfg, rcfg, state = reference_start("moonshot-v1-16b-a3b", seed=0)
    step = tstep.make_train_step(rcfg)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    first = None
    for i in range(25):
        state, m = step(state, data.batch(i))
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first
    H = state.router_H.numpy()
    assert H.max() < 25 * 4 * 32 * cfg.top_k


def test_grad_compression_training_converges():
    losses = {}
    for comp in ("none", "int8_ef"):
        cfg, rcfg, state = reference_start("olmo-1b", seed=1,
                                           grad_compression=comp)
        step = tstep.make_train_step(rcfg)
        data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=4, seed=1))
        ls = []
        for i in range(30):
            state, m = step(state, data.batch(i))
            ls.append(float(m["loss"]))
        losses[comp] = ls
    # compressed training tracks uncompressed within a loose factor
    assert losses["int8_ef"][-1] < losses["int8_ef"][0]
    assert abs(losses["int8_ef"][-1] - losses["none"][-1]) < 1.0


def test_grad_accum_matches_full_batch():
    """grad_accum=2 must give (nearly) the same first-step loss/update as
    the full batch: the accumulation is mathematically a mean."""
    cfg = tconfigs.reduced(tconfigs.get_config("olmo-1b"))
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=2)).batch(0)
    outs = {}
    for ga in (1, 2):
        rcfg = tconfigs.RunConfig(model=cfg, shape=tconfigs.ShapeConfig(
            "t", 32, 8, "train"), activ_dtype="float32", remat="none",
            grad_accum=ga)
        state, _ = tstep.init_train_state(
            rcfg, torch.Generator().manual_seed(3), device="cpu")
        new, m = tstep.make_train_step(rcfg)(state, batch)
        outs[ga] = (float(m["loss"]), float(global_norm(new.params)))
    assert outs[1][0] == pytest.approx(outs[2][0], rel=1e-4)
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-4)


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def test_train_entry_points_default_to_cuda(monkeypatch):
    """Without a card, the launcher without --device, `init_train_state`
    and `train_state_from_numpy` without a device raise; with
    ``device="cpu"`` they run on the CPU."""
    from repro_torch.launch.train import main as train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
    tcfg, jcfg = configs("qwen2-0.5b")
    rcfg = tconfigs.RunConfig(model=tcfg, shape=tconfigs.SHAPES["train_4k"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.init_train_state(rcfg, torch.Generator())
    jrcfg = jconfigs.RunConfig(model=jcfg, shape=jconfigs.SHAPES["train_4k"])
    jstate = to_numpy(jstep.init_train_state(jrcfg,
                                             key=jax.random.key(0))[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_from_numpy(jstate)
    state = train_state_from_numpy(jstate, "cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))
    with pytest.raises(ValueError, match="generator"):
        tstep.init_train_state(rcfg, torch.Generator(), device="meta")
