"""Dry-run: trace every (architecture x input shape) cell's step on the
meta device and record its memory, cost and roofline on the H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh local|single|multi|both]

Port of `repro.launch.dryrun`, with its names, CLI and record schema.
Where the reference lowers and compiles its jitted step on 512
placeholder devices, the port runs its own step function eagerly on
tensors of the meta device (shapes and dtypes, no storage) under
`TraceCounter`, a `TorchDispatchMode` that counts each operation as it
runs.  Nothing is allocated, so the trace runs on any host, with a card
or without.  As the reference lowers its einsum reference path and not
its Pallas kernels, the trace takes the plain path, which is what a
device other than CUDA selects (`models.attention.attention` picks its
core by the attention flags, `bp_topk_route` runs its plain version).

Meshes.  ``local`` (the default) is the port's one device,
`make_mesh_for(1)`: its records (status "ok") carry the whole roofline
on the H100's peaks, collective bytes 0 (one device has none).
``single`` and ``multi`` are the reference's 256- and 512-chip meshes,
logical here: the port cannot trace an SPMD program, so their records
(status "layout") carry the per-device argument bytes of the state,
batch and caches laid out by `runtime.sharding`, the parameter counts and
the model FLOPs, and a null roofline.  ``both`` is single + multi.

The roofline of a ``local`` record is the plain path's (the record's
``traced_path``): the naive attention's [S, S] scores, each kernel's
plain version and eager op-by-op bytes.  It upper-bounds the card's
kernel path; its ``dominant`` term and bound are not the card's (at 32k
the flash kernel writes no scores, and a prefill there is GEMM-bound).

The sLSTM's time loop is not traced step by step: under
`runtime.flags.single_slstm_step` it runs one step, and
`_slstm_correction` adds the other steps' cost, taken from the port's
own count.  The reference's depth probes (`--probe`) are not ported: the
port's trace sees every layer.

Results are JSON under results/dryrun_torch/ (one file per cell x mesh x
tag, apart from the reference's results/dryrun/); reruns skip cached
cells unless --force.  A failure is recorded with status=error, the sweep
continues and exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, RunConfig, ShapeConfig, cells, get_config
from ..models import get_model
from ..runtime import flags
from ..runtime import sharding as shd
from ..runtime.step import (init_train_state, make_prefill_step,
                            make_serve_step, make_train_step)
from . import roofline as rl
from .mesh import make_mesh_for, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: The mesh of each record name; single and multi are logical (layout
#: only, see the module docstring).
MESHES = {"local": lambda: make_mesh_for(1),
          "single": lambda: make_production_mesh(multi_pod=False),
          "multi": lambda: make_production_mesh(multi_pod=True)}


def tensors(tree, leaf=torch.Tensor) -> list:
    """The ``leaf`` instances (tensors, or the `NamedSharding`s of a
    sharding tree) of a tree of dicts, tuples and NamedTuples (None holds
    none), dict keys in sorted order: `jax.tree.leaves`' order."""
    if isinstance(tree, leaf):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k], leaf)]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors(x, leaf)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, each storage counted once."""
    seen = {}
    for t in tensors(tree):
        s = t.untyped_storage()
        seen.setdefault(id(s), s.nbytes())
    return sum(seen.values())


class TraceCounter(TorchDispatchMode):
    """Counts every operation that runs under it.

    * ``flops``: the FLOPs of each op that `torch.utils.flop_counter`
      prices (matrix products, convolutions, attention), by the dtype of
      its first input (torch's dtype name);
    * ``bytes``: the bytes of the input and output tensors of every op
      that is not a view.  This is the eager port's traffic, op by op: XLA
      fuses and the port does not, so it upper-bounds the reference path's
      traffic; it is not a bound on the card;
    * ``peak``: the largest sum of live storage bytes the step created,
      each storage counted once (a view adds nothing; a storage dies with
      its last tensor), the storages of ``arguments`` excluded;
    * ``n_ops``: the operations counted.
    """

    def __init__(self, arguments=()):
        super().__init__()
        self.flops: dict = {}
        self.bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        for t in arguments:
            self._note(t, counted=False)

    def _note(self, t: torch.Tensor, counted: bool = True) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._storages:
            return
        n = s.nbytes() if counted else 0
        self._storages[key] = weakref.ref(
            s, functools.partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int, _ref) -> None:
        self._storages.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        price = flop_registry.get(func._overloadpacket)
        if price is None:
            # A composite op (what inference mode hands the mode whole,
            # e.g. matmul, einsum) runs as the ops it is made of, each
            # counted here: `FlopCounterMode`'s rule.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.n_ops += 1
        ins = tensors((args, kwargs))
        outs = tensors(out)
        if price is not None:
            dt = str(ins[0].dtype).removeprefix("torch.")
            self.flops[dt] = self.flops.get(dt, 0) + int(
                price(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._note(t)
        return out


@dataclasses.dataclass
class Trace:
    """A traced step: its counter, its memory record and its seconds."""
    counter: TraceCounter
    memory: dict
    seconds: float


def trace_step(step, args, every_slstm_step: bool = False) -> Trace:
    """Run ``step(*args)`` on meta ``args`` under a `TraceCounter` (and
    the one-step sLSTM flag unless ``every_slstm_step``).  Memory: the
    arguments' bytes, the outputs' bytes, the aliased bytes (outputs
    written into the arguments' own storage: the port's in-place update
    of the donated state) and the peak of the step's own live storage."""
    bad = [t.device for t in tensors(args) if t.device.type != "meta"]
    if bad:
        raise ValueError(f"the dry-run traces meta tensors only, got {bad[0]}")
    counter = TraceCounter(tensors(args))
    t0 = time.perf_counter()
    with flags.single_slstm_step(not every_slstm_step), counter:
        out = step(*args)
    seconds = time.perf_counter() - t0
    arg_storages = {id(t.untyped_storage()) for t in tensors(args)}
    aliased = [t for t in tensors(out)
               if id(t.untyped_storage()) in arg_storages]
    memory = {"argument_size_in_bytes": tree_bytes(args),
              "output_size_in_bytes": tree_bytes(out),
              "temp_size_in_bytes": counter.peak,
              "alias_size_in_bytes": tree_bytes(aliased)}
    return Trace(counter=counter, memory=memory, seconds=seconds)


def _count_params(params) -> int:
    return sum(t.numel() for t in tensors(params))


def _paths(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif tree is not None:
        yield prefix, tree


def _active_params(cfg, params_tree) -> int:
    """Total params minus inactive expert fraction (MoE)."""
    total = 0
    for keys, leaf in _paths(params_tree):
        n = leaf.numel()
        if cfg.n_experts and "moe/" in keys and not keys.endswith("router"):
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return total


def device_bytes(values, axes, rules) -> int:
    """Per-device bytes of a value tree laid out by ``rules`` on its
    (logical) mesh: each leaf's shard under `runtime.sharding`."""
    shardings = tensors(shd.tree_shardings(values, axes, rules),
                        shd.NamedSharding)
    return sum(math.prod(s.shard_shape(v.shape)) * v.element_size()
               for v, s in zip(tensors(values), shardings))


def _slstm_correction(arch: str, cfg, shape: ShapeConfig,
                      rcfg_overrides: dict | None = None) -> dict:
    """The cost of the sLSTM time steps that the trace does not run (it
    steps once, `runtime.flags.single_slstm_step`), in the port's own
    count: FLOPs by dtype and bytes.

    D(S), a trace that runs every step less one that runs one, is affine
    in S: S - 1 more steps of the cell, and the stack of the steps'
    outputs (with its gradient in training) in place of the one step's
    expand and select; every other op is the same in both traces.  Two
    traces of each kind, of one sLSTM group at full width and the cell's
    batch with S = 2 and 3 tokens, fix D; D(S) times the model's sLSTM
    layers is the correction.  The reference's closed form (its
    `_slstm_correction`) prices the reference's step, whose gate inputs
    are inside the loop."""
    if cfg.family != "ssm" or not cfg.slstm_every or shape.kind == "decode":
        return {}
    group = dataclasses.replace(cfg, n_layers=cfg.slstm_every)
    off = 1 if shape.kind == "train" else 0     # training sees S - 1 inputs
    diffs = []
    for s in (2, 3):
        short = dataclasses.replace(shape, name=f"{shape.name}_s{s}",
                                    seq_len=s + off)
        one, full = (lower_cell(arch, short, rcfg_overrides=rcfg_overrides,
                                cfg=group, every_slstm_step=every)[0].counter
                     for every in (False, True))
        by = {dt: full.flops.get(dt, 0) - one.flops.get(dt, 0)
              for dt in sorted(set(full.flops) | set(one.flops))}
        diffs.append((by, full.bytes - one.bytes))
    (f2, b2), (f3, b3) = diffs
    n_slstm = cfg.n_layers // cfg.slstm_every
    S = shape.seq_len - off

    def at_s(d2, d3):                 # D(S) of all the sLSTM layers
        return n_slstm * (d2 + (S - 2) * (d3 - d2))

    by = {dt: at_s(f2[dt], f3[dt]) for dt in f2 if at_s(f2[dt], f3[dt])}
    return {"slstm_extra_flops": sum(by.values()),
            "slstm_extra_bytes": at_s(b2, b3),
            "slstm_extra_flops_by_dtype": by}


def _corrected(roof: rl.Roofline, corr: dict) -> rl.Roofline:
    """``roof`` plus the sLSTM correction."""
    if not corr:
        return roof
    by = dict(roof.flops_by_dtype)
    for dt, f in corr["slstm_extra_flops_by_dtype"].items():
        by[dt] = by.get(dt, 0) + f
    return rl.Roofline(
        flops_by_dtype=by,
        bytes_per_device=roof.bytes_per_device + corr["slstm_extra_bytes"])


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def lower_cell(arch: str, shape, *, mesh: str = "local",
               rcfg_overrides: dict | None = None, cfg=None,
               every_slstm_step: bool = False):
    """Build the cell's abstract state, batch and caches, lay them out on
    ``mesh`` and, on ``local``, trace the step (`trace_step`).  ``shape``
    is a name of `SHAPES` or a `ShapeConfig`.  Returns (trace or None on
    a logical mesh, meta, shape, cfg)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = _shape(shape)
    rcfg = RunConfig(model=cfg, shape=shape, multi_pod=mesh == "multi",
                     **(rcfg_overrides or {}))
    m = MESHES[mesh]()
    model_size = m.shape.get("model", 1)
    kv_seq_model = (rcfg.kv_seq_tp == "auto"
                    and cfg.n_kv_heads % model_size != 0
                    and shape.kind == "decode")
    rules = shd.make_rules(m, fsdp=rcfg.fsdp,
                           expert_parallel=rcfg.expert_parallel,
                           seq_shard_decode=rcfg.seq_shard_decode,
                           kv_seq_model=kv_seq_model)
    api = get_model(cfg)
    adt = torch.bfloat16

    with flags.attention_impl(rcfg.attn_impl), \
            flags.context_parallel(rcfg.ctx_par):
        state, axes = init_train_state(rcfg, abstract=True)
        specs, b_axes = api.batch_specs(shape, activ_dtype=adt)
        if shape.kind == "train":
            step = make_train_step(rcfg)
            args, arg_axes = (state, specs), (axes, b_axes)
        elif shape.kind == "prefill":
            step = make_prefill_step(rcfg)
            args = (state.params, specs, state.router_H)
            arg_axes = (axes.params, b_axes, axes.router_H)
        else:                            # decode
            caches = api.init_decode(shape.global_batch, shape.seq_len, adt,
                                     abstract=True)
            step = make_serve_step(rcfg)
            args = (state.params, caches, specs, state.router_H)
            arg_axes = (axes.params, api.cache_axes(caches), b_axes,
                        axes.router_H)
        per_device = device_bytes(args, arg_axes, rules)
        trace = (trace_step(step, args, every_slstm_step)
                 if mesh == "local" else None)

    meta = {"arch": arch, "shape": shape.name, "mesh": mesh,
            "chips": m.size,
            "n_params": _count_params(state.params),
            "active_params": _active_params(cfg, state.params),
            "argument_bytes_per_device": per_device,
            "rcfg": {k: v for k, v in dataclasses.asdict(rcfg).items()
                     if k not in ("model", "shape")}}
    return trace, meta, shape, cfg


def run_cell(arch: str, shape, *, mesh: str = "local",
             rcfg_overrides: dict | None = None, tag: str = "base",
             model_overrides: dict | None = None) -> dict:
    """One cell's record.  ``shape`` is a name of `SHAPES` or a
    `ShapeConfig` (a shape cut to one card)."""
    t0 = time.time()
    cfg0 = get_config(arch)
    if model_overrides:
        cfg0 = dataclasses.replace(cfg0, **model_overrides)
    trace, meta, shape, cfg = lower_cell(
        arch, shape, mesh=mesh, rcfg_overrides=rcfg_overrides, cfg=cfg0)
    t_lower = time.time() - t0
    per_device = meta.pop("argument_bytes_per_device")
    mf = rl.model_flops(cfg, shape, meta["n_params"], meta["active_params"])
    chips = meta["chips"]
    rec = {**meta, "tag": tag, "lower_s": round(t_lower, 2),
           "compile_s": None, "model_flops": mf, "hlo_bytes": None}
    if trace is None:
        rec.update(status="layout",
                   memory={"argument_size_in_bytes": per_device},
                   roofline_scanned=None, roofline=None,
                   useful_flops_ratio=None)
        return rec
    t0 = time.time()
    corr = _slstm_correction(arch, cfg, shape, rcfg_overrides)
    roof_raw = rl.from_trace(trace.counter)
    rec.update(status="ok", memory=trace.memory, traced_path="plain",
               trace_s=round(trace.seconds, 2), trace_ops=trace.counter.n_ops,
               roofline_scanned=roof_raw.summary())
    if corr:
        rec["slstm_correction"] = {**corr,
                                   "seconds": round(time.time() - t0, 2)}
    roof = _corrected(roof_raw, corr)
    rec["roofline"] = roof.summary()
    hlo_flops_global = roof.flops_per_device * chips
    rec["useful_flops_ratio"] = (mf / hlo_flops_global
                                 if hlo_flops_global else None)
    return rec


def cell_path(arch, shape_name, mesh_name, tag="base") -> Path:
    return RESULTS / f"{arch}__{shape_name}__{mesh_name}__{tag}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--set", nargs="*", default=[],
                    help="RunConfig overrides, e.g. fsdp=false remat=dots")
    ap.add_argument("--set-model", nargs="*", default=[],
                    help="ModelConfig overrides, e.g. capacity_factor=1.0")
    args = ap.parse_args(argv)

    def parse(pairs):
        out = {}
        for kv in pairs:
            k, v = kv.split("=")
            if v.lower() in ("true", "false"):
                out[k] = v.lower() == "true"
            elif v.isdigit():
                out[k] = int(v)
            else:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
        return out

    overrides = parse(args.set)
    model_overrides = parse(args.set_model)

    if args.all:
        todo = cells()
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]
    meshes = {"local": ["local"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    RESULTS.mkdir(parents=True, exist_ok=True)
    n_ok = n_err = n_skip = 0
    for arch, shape_name in todo:
        for mesh_name in meshes:
            out = cell_path(arch, shape_name, mesh_name, args.tag)
            if out.exists() and not args.force:
                n_skip += 1
                continue
            print(f"=== {arch} x {shape_name} x {mesh_name} [{args.tag}]",
                  flush=True)
            try:
                rec = run_cell(arch, shape_name, mesh=mesh_name,
                               rcfg_overrides=overrides, tag=args.tag,
                               model_overrides=model_overrides)
                if rec["status"] == "layout":
                    arg = rec["memory"]["argument_size_in_bytes"]
                    print(f"    layout: chips={rec['chips']} "
                          f"arg_bytes/dev={arg / 2**30:.3f}G "
                          f"lower={rec['lower_s']}s", flush=True)
                else:
                    r = rec["roofline"]
                    ratio = rec["useful_flops_ratio"]
                    print(f"    ok: trace={rec['trace_s']}s "
                          f"compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s "
                          f"dominant={r['dominant']} (plain path) "
                          f"useful={ratio and round(ratio, 3)}", flush=True)
                n_ok += 1
            except Exception as e:
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "tag": args.tag, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"    ERROR: {type(e).__name__}: {e}", flush=True)
                n_err += 1
            out.write_text(json.dumps(rec, indent=1))
    print(f"done: ok={n_ok} err={n_err} skipped={n_skip}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
