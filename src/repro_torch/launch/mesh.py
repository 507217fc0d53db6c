"""Production meshes (port of ``repro.launch.mesh``) as
``torch.distributed.device_mesh.DeviceMesh``es with the reference's axis
names.

Single pod: (data=16, model=16) = 256 chips.
Multi-pod:  (pod=2, data=16, model=16) = 512 chips; the ``pod`` axis
carries pure data / cohort parallelism (params replicated per pod, deltas
all-reduced across pods).

A mesh is built over the default process group, whose world size must be
the mesh's size.  One card holds no pod, so the dry run places a step on
the pod meshes under ``fake_group``: a process group of the fake backend
(``torch.testing``'s ``FakeStore``), in which this process is rank 0 and
every collective returns at once without moving data.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device

POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def mesh_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    return MULTI_POD if multi_pod else POD


def make_production_mesh(*, multi_pod: bool = False):
    """The (data, model) or (pod, data, model) mesh over the default group
    (world size 256 or 512, e.g. ``fake_group``'s), on the CPU device
    type: a pod is only ever placed, with meta shards, never run here."""
    shape, axes = mesh_shape(multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A (1, 1) mesh with the production axis names over a one-rank
    default group, on ``device``'s type (the GPU unless named): the same
    placed programs run on one card or on the CPU."""
    return init_device_mesh(resolve_device(device).type, (1, 1),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of any mesh-like object
    with a ``shape`` dict and ``axis_names`` (the reference's duck type)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch / participant-cohort dimension."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A default process group of the fake backend, rank 0 of
    ``world_size``, destroyed on exit.  Refuses to start when a default
    group exists already: it would be replaced under its owner."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "fake pod group is created and destroyed here")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
