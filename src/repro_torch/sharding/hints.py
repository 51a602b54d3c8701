"""Activation sharding hints, safe under any (or no) mesh.

Ported from ``repro.sharding.hints``.  ``hint(x, *axes)`` redistributes a
DTensor to the given per-dim mesh-axis names (``with_sharding_constraint``
in the reference), silently dropping names absent from the mesh; it does
nothing without an ambient mesh (:func:`repro_torch.launch.mesh.mesh_context`)
or on a plain tensor, which under a mesh is a rank's own local data.  "dp"
expands to whichever of ("pod", "data") exist.  Divisibility is checked, so
a hint never breaks a shape.
"""
from __future__ import annotations

import contextvars
import math
import sys

import torch

from .rules import Spec, placements

__all__ = ["ambient_mesh", "hint", "hint_spec", "is_dtensor"]

# The mesh that ``launch.mesh.mesh_context`` makes ambient (``jax.set_mesh``
# in the reference).  A context variable: each thread starts without one.
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                      default=None)


def ambient_mesh():
    """The ``DeviceMesh`` of the innermost ``mesh_context``, else None."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (without importing
    the module: where it was never imported, no DTensor exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def hint_spec(mesh, shape: tuple[int, ...], axes) -> Spec:
    """The spec ``hint`` applies: one entry a dim of ``shape`` (dims past
    ``axes`` replicated), names absent from ``mesh`` and entries whose
    mesh size does not divide the dim dropped to None."""
    names = set(mesh.mesh_dim_names)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    parts = []
    for dim, a in zip(shape, axes):
        if a == "dp":
            a = tuple(n for n in ("pod", "data") if n in names) or None
        if a is None:
            parts.append(None)
            continue
        tup = (a,) if isinstance(a, str) else tuple(a)
        if not all(t in names for t in tup):
            parts.append(None)
            continue
        size = math.prod(sizes[t] for t in tup)
        if size == 0 or dim % size != 0:
            parts.append(None)
            continue
        parts.append(tup[0] if len(tup) == 1 else tup)
    parts += [None] * (len(shape) - len(parts))
    return tuple(parts)


def hint(x: torch.Tensor, *axes):
    if ambient_mesh() is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh, hint_spec(mesh, tuple(x.shape), axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
