"""Mesh construction over the ``torch.distributed`` world (functions, not
module-level constants, so importing this module never touches a process
group).  Ported from ``repro.launch.mesh``.

The world is initialised by the caller (``init_process_group`` with its
address, world size and rank); a mesh here lays that world out as named
axes.  Each of these functions raises with the sizes when the world does
not match.
The device type is ``"cuda"`` (NCCL) unless the caller asks for ``"cpu"``
(gloo), as the tests do.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from ..sharding.hints import _MESH
from ..sharding.rules import MeshShape

__all__ = ["make_debug_mesh", "make_production_mesh", "mesh_context",
           "production_shape", "single_device_mesh"]


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs an initialised "
            f"torch.distributed world (init_process_group first)"
        )
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a {dict(zip(names, shape))} mesh needs {math.prod(shape)} "
            f"ranks; the world has {world}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; multi_pod adds a leading 2-pod axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The :func:`production_shape` mesh over a world of 256 (512) ranks."""
    s = production_shape(multi_pod=multi_pod)
    return _mesh(s.shape, s.mesh_dim_names, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    pods: int | None = None, device_type: str = "cuda"):
    """A small ("data", "model") mesh, ("pod", "data", "model") with
    ``pods``."""
    if pods:
        return _mesh((pods, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def single_device_mesh(device_type: str = "cuda"):
    """1x1 mesh over a world of one rank."""
    return _mesh((1, 1), ("data", "model"), device_type)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` ambient for the block (``jax.set_mesh``): the hints,
    the train step and the delivery engine's device steps read it.  A context variable, so it holds on the thread that
    entered the block (and in tasks it starts), not on other threads."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)
