"""Device meshes for the sharded steps and the dry run.

Functions, not module-level constants, so that importing this module
touches no process group: a mesh is made only after the process has one
(`torch.distributed.init_process_group`, over NCCL on the card, gloo on
the CPU, or the fake group of the dry run). A mesh's axes are named
(`mesh_dim_names`); `mesh_shape` reads them as a mapping, since a
`DeviceMesh`'s own `shape` is a tuple of sizes.
"""
from __future__ import annotations

import math


def make_mesh(shape: tuple, axes: tuple, *, device_type: str | None = None,
              ranks: list | None = None):
    """A `DeviceMesh` of `shape` over the ranks of the default process
    group, its dims named `axes`; with `ranks`, over those ranks alone (a
    smaller mesh after an elastic shrink; every rank of the group makes it
    all the same). `device_type` defaults to "cuda" when the process has a
    card and "cpu" otherwise."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if ranks is not None:
        return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                          mesh_dim_names=tuple(axes))
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The dry run's mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with `multi_pod`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or of any object whose `shape`
    is already such a mapping)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
