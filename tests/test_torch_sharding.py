"""The port's sharding rules and logical meshes against the reference's.

`repro.runtime.sharding.make_rules`/`spec_for` read only ``mesh.shape``,
so a stand-in object holding that dict serves them in this process (no
device count is forced here).  Every leaf of every architecture's
abstract train state, decode caches and batch specs must get the
reference's PartitionSpec on the 16x16 and 2x16x16 production meshes, and
the dry-run's per-device argument bytes on those meshes must equal the
shard arithmetic of the reference's specs.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import (make_mesh_for,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402
from repro_torch.runtime.sharding import P  # noqa: E402

MESHES = {"single": False, "multi": True}


def _rules(fsdp=True, ep=True):
    return shd.make_rules(make_mesh_for(1), fsdp=fsdp, expert_parallel=ep)


class TestSpecFor:
    def test_basic_mapping(self):
        r = _rules()
        spec = shd.spec_for((1024, 4096), ("embed", "ff"), r)
        assert spec == P(("data",), "model")

    def test_divisibility_fallback(self):
        r = shd.Rules(table={"heads": "model"}, mesh=make_mesh_for(1))
        assert shd.spec_for((0,), ("heads",), r) == P(None)
        # 14 heads on a 16-way model axis replicate; 32 shard
        r16 = shd.Rules(table={"heads": "model"},
                        mesh=make_production_mesh(multi_pod=False))
        assert shd.spec_for((14,), ("heads",), r16) == P(None)
        assert shd.spec_for((32,), ("heads",), r16) == P("model")

    def test_axis_reuse_guard(self):
        # the same mesh axis must not shard two dims of one tensor
        r = _rules()
        spec = shd.spec_for((64, 64), ("ff", "act_ff"), r)
        assert spec[0] == "model" and spec[1] is None

    @pytest.mark.parametrize("multi_pod", [False, True])
    def test_groups_stay_tuples_and_shards_divide(self, multi_pod):
        # a tuple entry (the FSDP group) stays a tuple when one axis is
        # left; a scalar entry stays scalar; a shard divides its dim
        mesh = make_production_mesh(multi_pod=multi_pod)
        r = shd.make_rules(mesh)
        spec = shd.spec_for((512, 64, 4096), ("embed", "ff", "ff"), r)
        groups = ("pod", "data") if multi_pod else ("data",)
        assert spec == P(groups, "model", None)
        assert shd.NamedSharding(mesh, spec).shard_shape((512, 64, 4096)) \
            == (512 // (32 if multi_pod else 16), 4, 4096)

    def test_ep_toggle(self):
        r_ep = _rules(ep=True)
        r_no = _rules(ep=False)
        assert r_ep.table["experts"] == "model"
        assert r_no.table["experts"] is None
        assert r_no.table["expert_ff"] == "model"


def flat(spec) -> tuple:
    """A spec's entries with one-axis groups as their axis: newer JAX
    stores ``P(("data",))`` as ``P("data")``, the reference's spec_for
    keeps the group, and the two shard alike."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def test_partition_spec_prints_as_jax():
    for entries in [("data", "model"), (None,), (("pod", "data"), None),
                    (), ("model", ("pod", "data"))]:
        assert repr(P(*entries)) == repr(JP(*entries))
        assert P(*entries) == tuple(JP(*entries))
    assert P(("data",), "model") != P("data", "model")
    assert flat(P(("data",), "model")) == tuple(JP(("data",), "model"))


def test_meshes():
    single, multi = (make_production_mesh(multi_pod=m) for m in (False,
                                                                  True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert make_mesh_for(8, 2).shape == {"data": 4, "model": 2}
    assert make_mesh_for(1).size == 1
    with pytest.raises(AssertionError):
        make_mesh_for(6, 4)
    sh = shd.NamedSharding(single, P(("data",), "model", None))
    assert sh.shard_shape((64, 48, 5)) == (4, 3, 5)


def stand_in(multi_pod: bool):
    """An object with the reference mesh's ``shape`` dict."""
    return types.SimpleNamespace(shape=make_production_mesh(
        multi_pod=multi_pod).shape)


def reference_trees(arch: str, shape_name: str):
    """The reference's abstract (values, axes) of a cell's step arguments,
    as `repro.launch.dryrun.lower_cell` builds them."""
    cfg = jconfigs.get_config(arch)
    shape = jconfigs.SHAPES[shape_name]
    rcfg = jconfigs.RunConfig(model=cfg, shape=shape)
    api = jget_model(cfg)
    state, axes = jstep.init_train_state(rcfg, abstract=True)
    specs, b_axes = api.batch_specs(shape, activ_dtype=jnp.bfloat16)
    if shape.kind == "train":
        return (state, specs), (axes, b_axes)
    if shape.kind == "prefill":
        return ((state.params, specs, state.router_H),
                (axes.params, b_axes, axes.router_H))
    caches = api.init_decode(shape.global_batch, shape.seq_len, jnp.bfloat16,
                             abstract=True)
    return ((state.params, caches, specs, state.router_H),
            (axes.params, api.cache_axes(caches), b_axes, axes.router_H))


def port_trees(arch: str, shape_name: str):
    cfg = tconfigs.get_config(arch)
    shape = tconfigs.SHAPES[shape_name]
    rcfg = tconfigs.RunConfig(model=cfg, shape=shape)
    api = get_model(cfg)
    state, axes = tstep.init_train_state(rcfg, abstract=True)
    specs, b_axes = api.batch_specs(shape)
    if shape.kind == "train":
        return (state, specs), (axes, b_axes)
    if shape.kind == "prefill":
        return ((state.params, specs, state.router_H),
                (axes.params, b_axes, axes.router_H))
    caches = api.init_decode(shape.global_batch, shape.seq_len,
                             torch.bfloat16, abstract=True)
    return ((state.params, caches, specs, state.router_H),
            (axes.params, api.cache_axes(caches), b_axes, axes.router_H))


def reference_leaves(values, axes):
    """(shape, itemsize, axes) of each leaf, jax's leaf order."""
    out = []
    jax.tree_util.tree_map(
        lambda v, a: out.append((tuple(v.shape),
                                 np.dtype(v.dtype).itemsize, a)),
        values, axes)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_specs_and_layout_bytes_equal_the_reference(arch, mesh):
    """Leaf for leaf, the port's spec of every argument of every cell of
    ``arch`` equals the reference's on ``mesh``; the dry-run's layout
    record holds the per-device bytes of the reference's specs."""
    multi = MESHES[mesh]
    jrules = jshd.make_rules(stand_in(multi))
    trules = shd.make_rules(make_production_mesh(multi_pod=multi))
    sizes = trules.mesh.shape
    for a, shape_name in tconfigs.cells():
        if a != arch:
            continue
        jv, ja = reference_trees(arch, shape_name)
        tv, ta = port_trees(arch, shape_name)
        ref = reference_leaves(jv, ja)
        port = shd.tree_shardings(tv, ta, trules)
        port_specs = dr.tensors(port, shd.NamedSharding)
        port_leaves = dr.tensors(tv)
        assert len(ref) == len(port_specs) == len(port_leaves)
        want_bytes = 0
        for (shp, itemsize, axes), s, v in zip(ref, port_specs, port_leaves):
            jspec = jshd.spec_for(shp, axes, jrules)
            assert flat(s.spec) == flat(jspec), (shape_name, shp, axes)
            assert tuple(v.shape) == shp
            shard = [d // math.prod(sizes[n] for n in
                                    ((e,) if isinstance(e, str) else e))
                     if e is not None else d
                     for d, e in zip(shp, flat(jspec))]
            want_bytes += math.prod(shard) * itemsize
        rec = dr.run_cell(arch, shape_name, mesh=mesh)
        assert rec["status"] == "layout" and rec["roofline"] is None
        assert rec["chips"] == (512 if multi else 256)
        assert rec["memory"]["argument_size_in_bytes"] == want_bytes
