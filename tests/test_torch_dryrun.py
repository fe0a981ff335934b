"""The port's dry-run stack against the reference's, on the CPU.

`repro.launch.dryrun` forces 512 host devices at import, so it is never
imported in this process: its parameter counts come from a subprocess,
and everything else is held against `repro.configs`, `repro.models`,
`repro.runtime.step`, `repro.launch.roofline` and `repro.runtime.flags`,
which set no flag.  The abstract state is compared at full width (both
sides are shapes only); the traces run at the reference's reduced widths
with the cells' shapes (a meta trace costs by operation count, not
size).  Tolerances: shapes, dtypes, axes and counts exactly; the chunked
attention forms within 1e-5 of the reference's under the same flags.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import Init as JInit  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import split_tree as jsplit  # noqa: E402
from repro.runtime import flags as jflags  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import flags as tflags  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list(tconfigs.ARCHS)
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def test_cells_listing():
    cs = tconfigs.cells()
    # 10 archs x 3 shapes + 2 sub-quadratic archs x long_500k
    assert len(cs) == 32
    assert ("zamba2-2.7b", "long_500k") in cs
    assert ("xlstm-350m", "long_500k") in cs
    assert ("gemma3-27b", "long_500k") not in cs
    assert len(tconfigs.cells(include_skipped=True)) == 40


def test_cells_and_archs_in_the_reference_order():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert tconfigs.cells() == jconfigs.cells()
    assert (tconfigs.cells(include_skipped=True)
            == jconfigs.cells(include_skipped=True))
    for name, cfg in tconfigs.ARCHS.items():
        assert cfg.is_subquadratic == jconfigs.ARCHS[name].is_subquadratic


# ---------------------------------------------------------------------------
# Abstract state at full width
# ---------------------------------------------------------------------------

def jleaves(tree):
    """(shape, dtype name) of each leaf of a reference tree, jax's
    order."""
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree_util.tree_leaves(tree)]


def tleaves(tree):
    """The same of a port tree, every leaf on the meta device."""
    leaves = dr.tensors(tree)
    assert all(t.device.type == "meta" for t in leaves)
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in leaves]


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_equals_the_reference(arch, compression):
    """Every leaf of `init_train_state(abstract=True)` (params, AdamW
    moments and count, step, router queues, residuals) has the reference's
    shape and dtype, on the meta device; the axes trees are equal."""
    run = dict(grad_compression=compression)
    trcfg = tconfigs.RunConfig(model=tconfigs.get_config(arch),
                               shape=tconfigs.SHAPES["train_4k"], **run)
    jrcfg = jconfigs.RunConfig(model=jconfigs.get_config(arch),
                               shape=jconfigs.SHAPES["train_4k"], **run)
    tstate, taxes = tstep.init_train_state(trcfg, abstract=True)
    jstate, jaxes = jstep.init_train_state(jrcfg, abstract=True)
    assert tleaves(tstate) == jleaves(jstate)
    assert tuple(taxes) == tuple(jaxes)
    assert (tstate.ef is None) == (compression == "none")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches_and_batch_specs_equal_the_reference(arch):
    """Decode caches (decode_32k, and long_500k where it is a cell) and
    every cell's batch specs: the reference's shapes, dtypes and axes."""
    tapi = get_model(tconfigs.get_config(arch))
    japi = jget_model(jconfigs.get_config(arch))
    for a, sname in tconfigs.cells():
        if a != arch:
            continue
        shape = tconfigs.SHAPES[sname]
        tspecs, taxes = tapi.batch_specs(shape)
        jspecs, jaxes = japi.batch_specs(jconfigs.SHAPES[sname])
        assert tleaves(tspecs) == jleaves(jspecs) and taxes == jaxes
        if shape.kind != "decode":
            continue
        tc = tapi.init_decode(shape.global_batch, shape.seq_len,
                              torch.bfloat16, abstract=True)
        jc = japi.init_decode(shape.global_batch, shape.seq_len,
                              jnp.bfloat16, abstract=True)
        assert tleaves(tc) == jleaves(jc)
        assert tapi.cache_axes(tc) == japi.cache_axes(jc)


REFERENCE_COUNTS = textwrap.dedent("""
    import json
    from repro.configs import RunConfig, SHAPES, get_config, ARCHS
    from repro.launch.dryrun import _active_params, _count_params
    from repro.runtime.step import init_train_state
    out = {}
    for name in ARCHS:
        rcfg = RunConfig(model=get_config(name), shape=SHAPES["train_4k"])
        state, _ = init_train_state(rcfg, abstract=True)
        out[name] = [_count_params(state.params),
                     _active_params(rcfg.model, state.params)]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_counts():
    out = subprocess.run([sys.executable, "-c", REFERENCE_COUNTS], env=ENV,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch, reference_counts):
    rcfg = tconfigs.RunConfig(model=tconfigs.get_config(arch),
                              shape=tconfigs.SHAPES["train_4k"])
    state, _ = tstep.init_train_state(rcfg, abstract=True)
    assert [dr._count_params(state.params),
            dr._active_params(rcfg.model, state.params)] == \
        reference_counts[arch]


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
def test_model_flops_equal_the_reference(shape):
    for arch in ARCHS:
        args = (12_345_678, 3_456_789)
        assert rl.model_flops(tconfigs.get_config(arch),
                              tconfigs.SHAPES[shape], *args) == \
            jrl.model_flops(jconfigs.get_config(arch),
                            jconfigs.SHAPES[shape], *args)


def test_roofline_terms_on_the_h100_peaks():
    assert rl.HBM_BW == 3.35e12
    assert rl.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    roof = rl.Roofline(flops_by_dtype={"bfloat16": 989e9, "float32": 67e9},
                       bytes_per_device=3.35e9)
    assert roof.flops_per_device == 989e9 + 67e9
    assert roof.compute_s == pytest.approx(2e-3, rel=1e-12)
    assert roof.memory_s == pytest.approx(1e-3, rel=1e-12)
    assert roof.dominant == "compute" and roof.bound_s == roof.compute_s
    summary = roof.summary()
    assert summary["flops_by_dtype"] == roof.flops_by_dtype
    # the reference's keys; one device has no collectives
    assert set(summary) >= {"compute_s", "memory_s", "collective_s",
                            "dominant", "flops_per_device",
                            "bytes_per_device", "coll_bytes_per_device",
                            "coll_breakdown"}
    assert summary["collective_s"] == summary["coll_bytes_per_device"] == 0
    with pytest.raises(KeyError, match="int32"):
        dataclasses.replace(roof, flops_by_dtype={"int32": 1.0}).compute_s


# ---------------------------------------------------------------------------
# Counts against arithmetic (reduced widths, the cells' shapes)
# ---------------------------------------------------------------------------

def reduced(arch, **over):
    return tconfigs.reduced(tconfigs.get_config(arch), **over)


def flops(trace) -> int:
    return sum(trace.counter.flops.values())


def test_dense_prefill_flops_equal_the_closed_form():
    """olmo-1b at reduced width, prefill_32k's shape (B=32, S=32,768):
    2 (matmul params) B S + the naive attention's 4 B S^2 H D per layer +
    the LM head on the last position."""
    cfg = reduced("olmo-1b", n_layers=3)
    shape = tconfigs.SHAPES["prefill_32k"]
    trace, meta, _, _ = dr.lower_cell("olmo-1b", shape, cfg=cfg)
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    d, H, KH, D, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    per_layer = d * H * D + 2 * d * KH * D + H * D * d + 3 * d * ff
    want = (2 * per_layer * L * B * S + 4 * B * S * S * H * D * L
            + 2 * B * d * cfg.vocab)
    assert trace.counter.flops == {"bfloat16": want}
    assert meta["n_params"] == per_layer * L + cfg.vocab * d
    assert trace.memory["alias_size_in_bytes"] == 0
    assert trace.memory["output_size_in_bytes"] == B * cfg.vocab * 2
    assert trace.memory["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("kind,remat", [("prefill", "full"),
                                        ("train", "full"),
                                        ("train", "none")])
def test_slstm_correction_is_the_untraced_steps(kind, remat):
    """The trace that runs every sLSTM step at S=64, less the one-step
    trace, equals `_slstm_correction` (taken from S = 2 and 3) in FLOPs by
    dtype and in bytes; 2 sLSTM layers."""
    cfg = reduced("xlstm-350m")
    assert cfg.n_layers // cfg.slstm_every == 2
    shape = tconfigs.ShapeConfig("s64", 64, 2, kind)
    over = {"remat": remat}
    one, _, _, _ = dr.lower_cell("xlstm-350m", shape, cfg=cfg,
                                 rcfg_overrides=over)
    full, _, _, _ = dr.lower_cell("xlstm-350m", shape, cfg=cfg,
                                  rcfg_overrides=over, every_slstm_step=True)
    corr = dr._slstm_correction("xlstm-350m", cfg, shape, over)
    assert flops(full) - flops(one) == corr["slstm_extra_flops"]
    assert (full.counter.flops["float32"] - one.counter.flops["float32"]
            == corr["slstm_extra_flops_by_dtype"]["float32"]
            == corr["slstm_extra_flops"])
    assert full.counter.bytes - one.counter.bytes == \
        corr["slstm_extra_bytes"]
    assert one.counter.n_ops < full.counter.n_ops
    roof = dr._corrected(rl.from_trace(one.counter), corr)
    assert roof.flops_by_dtype == full.counter.flops
    assert roof.bytes_per_device == full.counter.bytes


def test_single_slstm_step_refuses_real_tensors():
    cfg = reduced("xlstm-350m")
    from repro_torch.models import xlstm
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    p = params["stack"]["slstm"]
    lp = {k: v.value[0] for k, v in p.items() if v is not None}
    x = torch.randn(2, 8, cfg.d_model)
    with tflags.single_slstm_step(), pytest.raises(RuntimeError,
                                                   match="meta"):
        xlstm.slstm_fwd(cfg, lp, x)


# ---------------------------------------------------------------------------
# The attention core off the card, by the flags
# ---------------------------------------------------------------------------

ATTN_CASES = [("naive", False, None, True), ("chunked", False, None, True),
              ("chunked", False, 8, True), ("chunked", False, None, False),
              ("chunked", True, None, True), ("chunked", True, 8, True)]


@pytest.mark.parametrize("impl,ctx,window,causal", ATTN_CASES)
def test_cpu_attention_follows_the_flags_as_the_reference(impl, ctx, window,
                                                          causal):
    """`attention` on the CPU under the reference's flags equals the
    reference's within 1e-5, at a length beyond one 2,048-row chunk."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen2-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen2-0.5b"))
    B, S = 1, 2200
    p, _ = jsplit(jattn.init_attn(jcfg, JInit(key=jax.random.key(0))))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    with jflags.attention_impl(impl), jflags.context_parallel(ctx):
        want = np.asarray(jattn.attention(jcfg, p, jnp.asarray(x),
                                          jnp.asarray(pos), window=window,
                                          causal=causal))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")
    with tflags.attention_impl(impl), tflags.context_parallel(ctx):
        got = tattn.attention(tcfg, tp, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), window=window,
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The CLI and the report
# ---------------------------------------------------------------------------

CLI = textwrap.dedent("""
    import pathlib, sys
    import repro_torch.launch.dryrun as dr
    import repro_torch.launch.report as report
    assert "jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules)
    dr.RESULTS = report.RESULTS = pathlib.Path(sys.argv[1])
    dr.main(sys.argv[2:])
    report.main(["--mesh", sys.argv[sys.argv.index("--mesh") + 1]])
""")

SMALL = ["d_model=64", "n_heads=4", "n_kv_heads=4", "head_dim=16",
         "d_ff=128", "vocab=256", "n_layers=2"]


@pytest.mark.parametrize("mesh,status", [("local", "ok"),
                                         ("single", "layout")])
def test_cli_writes_a_record_and_the_report_renders_it(tmp_path, mesh,
                                                       status):
    """`python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    --mesh ...`'s main, at reduced width (--set-model), its record holding
    the reference's keys; `report.main` renders it; no JAX imported."""
    out = subprocess.run(
        [sys.executable, "-c", CLI, str(tmp_path), "--arch", "olmo-1b",
         "--shape", "train_4k", "--mesh", mesh, "--set-model", *SMALL],
        env=ENV, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / f"olmo-1b__train_4k__{mesh}__base.json")
                     .read_text())
    keys = {"arch", "shape", "mesh", "chips", "n_params", "active_params",
            "rcfg", "tag", "status", "lower_s", "compile_s", "memory",
            "roofline_scanned", "model_flops", "hlo_bytes", "roofline",
            "useful_flops_ratio"}
    assert keys <= set(rec) and rec["status"] == status
    assert "ok=1 err=0" in out.stdout
    assert "| olmo-1b | train_4k |" in out.stdout
    if status == "ok":
        assert rec["chips"] == 1 and rec["traced_path"] == "plain"
        assert rec["roofline"]["coll_bytes_per_device"] == 0.0
        assert "Traced on the plain path" in out.stdout
        assert set(rec["memory"]) == {
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes"}
        assert 0 < rec["useful_flops_ratio"] <= 1.5
    else:
        assert rec["roofline"] is None and rec["chips"] == 256
        assert "layout record(s) on the single mesh skipped" in out.stdout
    tables = report.roofline_table([rec], mesh)
    assert ("| olmo-1b |" in tables) == (status == "ok")
    if status == "ok":
        assert report.pick_hillclimb_targets([rec], mesh)[0] == (
            "olmo-1b", "train_4k", "worst peak fraction (plain path)")
    assert report.dryrun_table([rec]).count("| olmo-1b |") == 1
