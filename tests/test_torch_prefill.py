"""The port's prefill slice against the reference, on the CPU.

Both packages run on the same weights (the reference's, carried across by
`convert.params_from_numpy`) and the same inputs (numpy, fixed seeds), at
the reference's reduced sizes of granite-moe-1b-a400m and qwen2-0.5b, in
float32.  Tolerances:

  * `attention` against the reference's under both of its impls ("naive"
    materialized scores and "chunked" online softmax): 1e-5;
  * `lm_logits` and the router queues H' against the reference: the same
    experts in every layer, logits within rtol 1e-4 / atol 1e-5 (XLA and
    torch sum the matmuls and the softmax in other orders, and the port
    routes through `bp_topk_route`'s plain version), H' within 1e-5;
  * the port's forward against its own step-by-step decode: 2e-3, the
    bound of `tests/test_models_consistency.py:38`;
  * `make_prefill_step` against `lm_logits(last_only=True)`: equal.

The card-only check of this path (the prefill on the card against the CPU)
is in `tests/test_torch_flash_attention.py`, which needs no JAX.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.runtime import flags as jflags  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.bp_topk import kernel as topk_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model, moe as tmoe, split_tree  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "qwen2-0.5b")
B, S = 2, 12
ROOT = pathlib.Path(__file__).resolve().parents[1]


def configs(arch, **over):
    """(port config, reference config), reduced, with the same overrides."""
    return (tconfigs.reduced(tconfigs.get_config(arch), **over),
            jconfigs.reduced(jconfigs.get_config(arch), **over))


def weights(jcfg, seed=1):
    """(reference params, the same params as the port's tensors)."""
    values, _ = jsplit(jget_model(jcfg).init(key=jax.random.key(seed)))
    return values, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            values), "cpu")


def router_H(cfg, seed=2):
    """Non-zero queues [L, E], so the backpressure bias steers the picks."""
    if cfg.family != "moe":
        return None
    rng = np.random.default_rng(seed)
    return (rng.random((cfg.n_layers, cfg.n_experts)) * 2).astype(np.float32)


def tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_matches_reference(arch, impl, window):
    tcfg, jcfg = configs(arch)
    jp, tp = weights(jcfg)
    jattn_p = jax.tree_util.tree_map(lambda a: a[0],
                                     jp["stack"]["layers"]["attn"])
    tattn_p = {k: v[0] for k, v in tp["stack"]["layers"]["attn"].items()}
    x = np.random.default_rng(0).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    got = tattn.attention(tcfg, tattn_p, torch.from_numpy(x),
                          torch.from_numpy(pos.copy()), window=window)
    with jflags.attention_impl(impl):
        want = jattn.attention(jcfg, jattn_p, jnp.asarray(x),
                               jnp.asarray(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The forward: lm_logits and the router queues
# ---------------------------------------------------------------------------

def recording(module, picks):
    """A `_route` of ``module`` that appends each call's expert picks."""
    original = module._route

    def route(*args, **kw):
        out = original(*args, **kw)
        picks.append(np.asarray(out[0]))
        return out
    return route


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_logits_and_router_H_match_reference(arch, monkeypatch):
    tcfg, jcfg = configs(arch)
    jp, tp = weights(jcfg)
    H = router_H(tcfg)
    toks = tokens(tcfg)
    tpicks, jpicks = [], []
    monkeypatch.setattr(tmoe, "_route", recording(tmoe, tpicks))
    monkeypatch.setattr(jmoe, "_route", recording(jmoe, jpicks))
    logits, tH, _ = ttransformer.lm_logits(
        tcfg, tp, torch.from_numpy(toks), activ_dtype=torch.float32,
        router_H=None if H is None else torch.from_numpy(H))
    with jax.disable_jit():        # the layer scan runs eagerly: picks
        jlogits, jH, _ = jtransformer.lm_logits(
            jcfg, jp, jnp.asarray(toks), activ_dtype=jnp.float32,
            remat="none", router_H=None if H is None else jnp.asarray(H))
    assert logits.shape == (B, S, tcfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    if H is None:
        assert tH is None and jH is None and not tpicks and not jpicks
        return
    assert len(tpicks) == len(jpicks) == tcfg.n_layers
    for layer, (t, j) in enumerate(zip(tpicks, jpicks)):
        np.testing.assert_array_equal(t, j, err_msg=f"layer {layer}")
    assert tH.shape == (tcfg.n_layers, tcfg.n_experts)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), atol=1e-5)
    assert not np.allclose(tH.numpy(), H)          # the queues moved


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_stepwise_decode(arch):
    """tests/test_models_consistency.py::test_decode_matches_forward, on
    the port: decoding token by token reproduces the forward's logits."""
    tcfg, _ = configs(arch)
    api = get_model(tcfg)
    params, _ = split_tree(api.init(torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(tokens(tcfg, seed=4))
    H = api.init_state(device="cpu").router_H
    full, _, _ = api.logits(params, {"tokens": toks},
                            activ_dtype=torch.float32, router_H=H)
    caches = api.init_decode(B, S + 2, torch.float32, device="cpu")
    for t in range(S):
        step, caches = api.decode_step(params, caches,
                                       {"tokens": toks[:, t]},
                                       activ_dtype=torch.float32, router_H=H)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"{arch} step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_is_last_position_logits(arch):
    tcfg, jcfg = configs(arch)
    _, tp = weights(jcfg)
    H = router_H(tcfg)
    H = None if H is None else torch.from_numpy(H)
    toks = torch.from_numpy(tokens(tcfg))
    flash0 = flash_kernel.flash_attention.launches
    topk0 = topk_kernel.bp_topk.launches
    route0 = topk_kernel.bp_topk_route.launches
    for adt in ("float32", "bfloat16"):
        rcfg = tconfigs.RunConfig(tcfg, tconfigs.SHAPES["prefill_32k"],
                                  activ_dtype=adt)
        got = tstep.make_prefill_step(rcfg)(tp, {"tokens": toks}, H)
        last, _, _ = ttransformer.lm_logits(
            tcfg, tp, toks, activ_dtype=getattr(torch, adt), router_H=H,
            last_only=True)
        full, _, _ = ttransformer.lm_logits(
            tcfg, tp, toks, activ_dtype=getattr(torch, adt), router_H=H)
        assert got.shape == (B, 1, tcfg.vocab)
        assert got.dtype == getattr(torch, adt)
        assert torch.equal(got, last)
        tol = 1e-6 if adt == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   full[:, -1:].float().numpy(), rtol=tol,
                                   atol=tol)
    # the CPU runs the plain versions: no kernel launch is counted
    assert flash_kernel.flash_attention.launches == flash0
    assert topk_kernel.bp_topk.launches == topk0
    assert topk_kernel.bp_topk_route.launches == route0


def test_serve_step_is_the_decode_step():
    tcfg, jcfg = configs("granite-moe-1b-a400m")
    _, tp = weights(jcfg)
    api = get_model(tcfg)
    rcfg = tconfigs.RunConfig(tcfg, tconfigs.SHAPES["decode_32k"],
                              activ_dtype="float32")
    serve = tstep.make_serve_step(rcfg)
    caches = [api.init_decode(B, 8, torch.float32, device="cpu")
              for _ in range(2)]
    H = api.init_state(device="cpu").router_H
    for t in range(3):
        batch = {"tokens": torch.tensor([t, t + 5])}
        a, caches[0] = serve(tp, caches[0], batch, H)
        b, caches[1] = api.decode_step(tp, caches[1], batch,
                                       activ_dtype=torch.float32, router_H=H)
        assert torch.equal(a, b)


def test_run_and_shape_configs_are_the_references():
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == \
            dataclasses.asdict(shape)
    tcfg, jcfg = configs("granite-moe-1b-a400m")
    tr = tconfigs.RunConfig(tcfg, tconfigs.SHAPES["prefill_32k"])
    jr = jconfigs.RunConfig(jcfg, jconfigs.SHAPES["prefill_32k"])
    tfields = {f.name: getattr(tr, f.name)
               for f in dataclasses.fields(tr) if f.name not in ("model",
                                                                 "shape")}
    jfields = {f.name: getattr(jr, f.name)
               for f in dataclasses.fields(jr) if f.name not in ("model",
                                                                 "shape")}
    assert tfields == jfields
    assert tstep._dtype(tr.activ_dtype) is torch.bfloat16


def test_moe_stack_needs_router_queues_and_local_global_is_refused():
    tcfg, jcfg = configs("granite-moe-1b-a400m")
    _, tp = weights(jcfg)
    toks = torch.from_numpy(tokens(tcfg))
    with pytest.raises(ValueError, match="router_H"):
        ttransformer.lm_logits(tcfg, tp, toks)
    # the local/global pattern runs since the dense family's slice; a
    # family another module stacks is refused, with or without it, naming
    # that module
    for family, module in (("hybrid", "models.zamba"),
                           ("ssm", "models.xlstm")):
        other = dataclasses.replace(tcfg, family=family, local_global=5)
        with pytest.raises(ValueError, match=module):
            ttransformer.stack_fwd(other, tp["stack"], torch.zeros(
                (B, S, tcfg.d_model)), torch.arange(S)[None])


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" /
              "torch_prefill_repeat.py"]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)} imports {name}"
