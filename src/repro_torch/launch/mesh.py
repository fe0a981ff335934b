"""Logical meshes: axis names and sizes, no devices.

Port of `repro.launch.mesh`.  The port runs on one device and places
nothing on a mesh; a `Mesh` here is what the sharding arithmetic
(`runtime.sharding`) reads, ``mesh.shape`` a dict of axis sizes as in
JAX.  The dry-run (`launch.dryrun`) lays its state out on the reference's
production meshes and traces on the one-device `make_mesh_for(1)`.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips ("data","model"); multi-pod: 2 pods of
    256 = 512 chips ("pod","data","model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh_for(n_devices: int, model_parallel: int = 1) -> Mesh:
    """A (data, model) mesh over ``n_devices`` (the reference's elastic
    helper)."""
    assert n_devices % model_parallel == 0
    return Mesh(("data", "model"), (n_devices // model_parallel,
                                    model_parallel))
