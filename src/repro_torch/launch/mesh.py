"""Mesh construction.  Functions, not module constants: importing this
module touches no process group.

The production and stencil meshes are shapes with names
(:class:`~repro_torch.sharding.MeshShape`): the dry run reads their
shard shapes with no devices.  :func:`build` makes a ``DeviceMesh`` of
one, which needs a world of exactly that many ranks.
"""
from __future__ import annotations

import torch

from ..sharding import MeshShape, route_gloo_gathers


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh: 16x16 = 256 chips a pod; 2 pods multi-pod."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def stencil_mesh_shape(ndim: int, *, multi_pod: bool = False) -> MeshShape:
    """Grid-aligned mesh for the distributed stencil runtime: one mesh
    axis per (sharded) grid dimension, over the production mesh's
    device count."""
    n = 512 if multi_pod else 256
    if ndim == 1:
        return MeshShape((n,), ("sx",))
    if ndim == 2:
        return MeshShape((n // 16, 16), ("sx", "sy"))
    return MeshShape((8, 8, 8) if multi_pod else (4, 8, 8),
                     ("sx", "sy", "sz"))


def build(shape: MeshShape, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group,
    whose world must hold ``shape.size`` ranks (raises otherwise).
    Every rank must call it, in the same order as its other meshes
    (``init_device_mesh`` is collective).  A CUDA mesh over a gloo world
    routes DTensor's all-gathers (:func:`~repro_torch.sharding.
    route_gloo_gathers`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape.shape_tuple} mesh needs an initialised "
                           "process group")
    world = dist.get_world_size()
    if world != shape.size:
        raise RuntimeError(f"a {shape.shape_tuple} mesh needs {shape.size} "
                           f"ranks; the world has {world}")
    dev = torch.device(device).type
    if dev == "cuda" and dist.get_backend() == "gloo":
        route_gloo_gathers("cuda")
    return init_device_mesh(dev, shape.shape_tuple,
                            mesh_dim_names=shape.axis_names)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *, n_pod: int = 0,
                   device="cuda"):
    """A small ``("data", "model")`` mesh (``("pod", "data", "model")``
    with ``n_pod``) over the world's ranks, on ``device``'s type
    (``"cpu"`` for gloo worlds on the host)."""
    if n_pod:
        return build(MeshShape((n_pod, n_data, n_model),
                               ("pod", "data", "model")), device)
    return build(MeshShape((n_data, n_model), ("data", "model")), device)
