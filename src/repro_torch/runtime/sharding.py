"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) with divisibility
fallback.

Port of `repro.runtime.sharding`.  Params and activations carry *logical*
axis names; `make_rules` maps them to mesh axes given the RunConfig knobs,
and `spec_for` drops any mesh axis that does not divide the concrete dim
(e.g. qwen2's 14 heads on a 16-way model axis -> replicated heads, sharded
FFN/vocab).

The port runs on one device and places nothing: its meshes are logical
(`launch.mesh.Mesh`, axis names and sizes), and a `NamedSharding` here is
a (mesh, spec) pair whose one use is arithmetic, the shape of one
device's shard (`shard_shape`).  The dry-run (`launch.dryrun`) reads the
per-device bytes of its logical meshes from it.  The reference's
`use_rules`/`active_rules`/`constrain` (sharding constraints inside the
step) are not ported: a one-device process has nothing to constrain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), a mesh axis
    name, or a tuple of them.  A tuple, printed as JAX's
    `PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict
    mesh: object                  # anything with a `.shape` dict

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)


def make_rules(mesh, *, fsdp: bool = True, expert_parallel: bool = True,
               seq_shard_decode: bool = True,
               kv_seq_model: bool = False) -> Rules:
    """kv_seq_model: shard the KV-cache sequence dim over the *model* axis
    (flash-decode style partial-softmax) — the right call when kv_heads do
    not divide the model axis (else the cache would be replicated 16x)."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    tp = "model" if "model" in mesh.shape else None
    fs = dp_axes if fsdp else None
    table = {
        # ---- parameter logical axes
        "layers": None,
        "embed": fs,                      # FSDP shards the d_model dim
        "vocab": tp,
        "heads": tp,
        "kv_heads": tp,
        "head_dim": None,
        "ff": tp,
        "experts": tp if expert_parallel else None,
        "expert_ff": None if expert_parallel else tp,
        "dinner": tp,                     # SSM inner channels
        "conv": None,
        "state": None,
        "ssm_heads": tp,
        # ---- activation logical axes
        "act_batch": dp_axes,
        "act_group": dp_axes,
        "act_seq": None,
        "act_seq_ctx": tp,                # context-parallel attention
        "act_embed": None,
        "act_ff": tp,
        "act_heads": tp,
        "act_kv_heads": tp,
        "act_dinner": tp,
        "act_experts": tp if expert_parallel else None,
        "cache_seq": (("model",) if kv_seq_model else
                      (dp_axes if seq_shard_decode else None)),
        "cache_batch": dp_axes,
    }
    return Rules(table=table, mesh=mesh)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules) -> P:
    """PartitionSpec with divisibility-aware fallback to replication.

    Tuple-vs-scalar normalization: a rules-table entry that is a *tuple* of
    mesh axes (a multi-axis group like the FSDP ``("pod", "data")``) stays a
    tuple in the spec even when only one axis survives filtering, so that
    specs built from the same table compare equal whatever the mesh size
    (``P("data") != P(("data",))``).  Scalar (str) entries stay scalar.  A
    mesh axis shards at most one dim of a tensor (the axis-reuse guard)."""
    entries = []
    used = set()
    for dim, ax in zip(shape, axes):
        mesh_axes = rules.table.get(ax) if ax else None
        if mesh_axes is None:
            entries.append(None)
            continue
        grouped = not isinstance(mesh_axes, str)
        if not grouped:
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        size = (math.prod(rules.mesh.shape[a] for a in mesh_axes)
                if mesh_axes else 1)
        if mesh_axes and dim % size == 0 and dim > 0:
            entries.append(mesh_axes if grouped else mesh_axes[0])
            used.update(mesh_axes)
        else:
            entries.append(None)
    return P(*entries)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a logical mesh (JAX's `NamedSharding`, without devices)."""
    mesh: object
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """One device's shard of a tensor of ``shape``."""
        out = []
        for i, dim in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            if entry is None:
                out.append(int(dim))
                continue
            names = (entry,) if isinstance(entry, str) else entry
            out.append(int(dim) // math.prod(self.mesh.shape[a]
                                             for a in names))
        return tuple(out)


def sharding_for(value, axes, rules: Rules) -> NamedSharding:
    return NamedSharding(rules.mesh, spec_for(value.shape, axes, rules))


def tree_map_axes(fn, values, axes_tree):
    """``fn(leaf, axes)`` over a value tree (dicts, NamedTuples and tuples
    of tensors, None) and its axes tree, as `jax.tree_util.tree_map` does
    with the value tree first: the structure is the values', and each
    tensor leaf gets its matching axes subtree (a tuple of names) whole."""
    if values is None:
        return None
    if isinstance(values, torch.Tensor):
        return fn(values, axes_tree)
    if isinstance(values, dict):
        return {k: tree_map_axes(fn, values[k], axes_tree[k])
                for k in values}
    if isinstance(values, tuple):
        out = [tree_map_axes(fn, v, a) for v, a in zip(values, axes_tree)]
        return type(values)(*out) if hasattr(values, "_fields") else tuple(out)
    raise TypeError(f"tree_map_axes: unexpected node {type(values)}")


def tree_shardings(values, axes_tree, rules: Rules):
    """Map an (abstract) value tree + logical-axes tree -> NamedSharding
    tree."""
    return tree_map_axes(lambda v, a: sharding_for(v, a, rules), values,
                         axes_tree)
