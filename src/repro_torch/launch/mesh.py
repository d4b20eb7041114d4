"""Production mesh construction.

The reference's production layout: TPU v5e, 16 x 16 = 256 chips per pod;
multi-pod = 2 pods = 512 chips with a leading "pod" data-parallel axis. It
is kept so that the spec trees (``sharding_rules``) and the dry-run's
per-device figures match the reference's; it makes no claim about the
H100, which the port serves and trains on alone.

Each mesh is a DTensor ``DeviceMesh`` over a *fake* process group of 256
or 512 ranks (PyTorch's testing backend "fake": this process is rank 0,
and a collective returns at once and moves nothing), so the dry-run can
place meta tensors on it. Defined as functions, not constants: importing
this module creates no process group; the first call does, and a call for
the other mesh size replaces it.
"""
from __future__ import annotations

import math

_MESHES: dict = {}


def make_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0. Replaces a fake
    group of another size; refuses to replace a real one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "fake production mesh would replace it")
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(axes))
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple:
    """Axes that carry batch parallelism (pod folds into data)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
