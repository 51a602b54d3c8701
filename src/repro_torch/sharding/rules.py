"""Logical-axis -> mesh-axis sharding rules (t5x-style), on torch meshes.

Ported from ``repro.sharding.rules``.  Every parameter / cache / activation
dim carries a logical axis name (``ParamDef.axes``, see
:mod:`repro_torch.models.base`); a rule table maps names to mesh axes.  Spec
building is *divisibility-checked*: a dim that is not divisible by its mesh
axis size falls back to replication, and the fallback is recorded ("kv_heads
8 replicated over model=16") instead of failing.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
dim: ``None`` (replicated), a mesh axis name, or a tuple of names (the dim
split over those axes, major to minor).  :meth:`Rules.placements_for` turns
it into DTensor placements, one a mesh dim, only where a tensor is placed.

Mesh axes:
  "pod"    cross-pod data parallelism (multi-pod mesh only)
  "data"   in-pod data parallelism / FSDP
  "model"  tensor/expert parallelism

The rules read only names and sizes from a mesh, so they take a
``torch.distributed.device_mesh.DeviceMesh`` or a :class:`MeshShape`
(no process group needed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

__all__ = [
    "MeshShape", "NamedSharding", "Rules", "activation_rules",
    "cache_rules", "delivery_rules", "dp_axes", "opt_state_rules",
    "param_rules", "placements", "shard_tensor", "shard_tree",
    "tree_shardings",
]

MeshAxes = str | tuple[str, ...] | None
Spec = tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices (``AbstractMesh`` in
    the reference): spelled as ``DeviceMesh`` spells them."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.mesh_dim_names) != len(self.shape):
            raise ValueError(f"{self.mesh_dim_names} names for "
                             f"{self.shape} sizes")


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes: ('pod','data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements (one a mesh dim) for ``spec``: ``Shard(d)`` on
    every mesh dim that dim ``d`` is split over, ``Replicate()`` on the
    rest.  A dim split over several mesh dims is split in mesh-dim order,
    major to minor, which is what JAX does for a tuple entry; an entry
    whose axes are out of mesh-dim order has no such placement and
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is out of mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass(frozen=True)
class Rules:
    table: Mapping[str, MeshAxes]
    mesh: Any                       # DeviceMesh or MeshShape

    def axis_size(self, axes: MeshAxes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = _sizes(self.mesh)
        return math.prod(sizes[a] for a in axes)

    def spec_for(self, logical: tuple[str | None, ...], shape: tuple[int, ...],
                 fallbacks: list[str] | None = None) -> Spec:
        parts = []
        used: set[str] = set()
        for name, dim in zip(logical, shape):
            m = self.table.get(name) if name else None
            if m is None:
                parts.append(None)
                continue
            maxes = (m,) if isinstance(m, str) else tuple(m)
            # drop mesh axes already consumed by an earlier dim of this array
            maxes = tuple(a for a in maxes if a not in used)
            if not maxes:
                parts.append(None)
                continue
            if dim % self.axis_size(maxes) != 0:
                if fallbacks is not None:
                    fallbacks.append(
                        f"{name}={dim} not divisible by {maxes} "
                        f"(size {self.axis_size(maxes)}): replicated"
                    )
                parts.append(None)
                continue
            used.update(maxes)
            parts.append(maxes[0] if len(maxes) == 1 else maxes)
        return tuple(parts)

    def placements_for(self, logical, shape, fallbacks=None) -> tuple:
        return placements(self.mesh, self.spec_for(logical, shape, fallbacks))

    def sharding_for(self, logical, shape, fallbacks=None) -> NamedSharding:
        return NamedSharding(self.mesh,
                             self.spec_for(logical, shape, fallbacks))


def param_rules(mesh, fsdp: bool = True) -> Rules:
    """Parameter placement: TP over "model", optional FSDP over "data"."""
    table: dict[str, MeshAxes] = {
        "vocab": "model",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": "model",
        "rnn": "model",
        "lora": None,
        "layers": None,
        "embed": dp_axes(mesh) if fsdp else None,
    }
    return Rules(table, mesh)


def opt_state_rules(mesh) -> Rules:
    """ZeRO-1: optimizer moments always FSDP-shard the embed dim."""
    return param_rules(mesh, fsdp=True)


def activation_rules(mesh) -> Rules:
    """Streaming activations: batch over dp axes, heads/ffn over model."""
    table: dict[str, MeshAxes] = {
        "batch": dp_axes(mesh),
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "embed": None,
        "kv_seq": None,
    }
    return Rules(table, mesh)


def cache_rules(mesh, seq_shard: bool = False) -> Rules:
    """KV-cache placement for serving.

    Default: batch over dp axes, kv_heads over model.  ``seq_shard=True``
    switches to sequence-sharded caches over "model" (flash-decoding-style
    split-KV), for kv_heads too few to fill the model axis.
    """
    table: dict[str, MeshAxes] = {
        "batch": dp_axes(mesh),
        "kv_heads": None if seq_shard else "model",
        "kv_seq": "model" if seq_shard else None,
        "heads": None if seq_shard else "model",
        "rnn": None if seq_shard else "model",
        "embed": None,
        "lora": None,
        "layers": None,
    }
    return Rules(table, mesh)


def delivery_rules(mesh) -> Rules:
    """The delivery engine's microbatch placement
    (:mod:`repro_torch.runtime.engine`).

    The microbatch is (group, rows, features) with one tenant per group; the
    group axis is embarrassingly parallel (each group carries its own secret
    core / Aug-Conv matrix) and shards over the data-parallel axes.  Rows and
    feature dims stay local so each rank runs whole per-tenant GEMMs:
    morphing never needs a cross-rank contraction.  The stacked secrets
    (S, q, q) / (S, F_in, F_out) are replicated: every rank may serve any
    tenant.
    """
    table: dict[str, MeshAxes] = {
        "group": dp_axes(mesh),
        "rows": None,
        "features": None,
        "out_features": None,
        "tenant": None,       # stacked secrets: replicated
        "core_in": None,
        "core_out": None,
    }
    return Rules(table, mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _zip_map(fn, axes_tree, tree):
    """``fn(axes, leaf)`` over an axes tree and a tree of the same structure
    (nested dicts / lists, or a ``ParamTree``), as nested dicts / lists."""
    if _is_axes(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: _zip_map(fn, a, tree[k]) for k, a in axes_tree.items()}
    return [_zip_map(fn, a, t) for a, t in zip(axes_tree, tree, strict=True)]


def tree_shardings(rules: Rules, axes_tree: Any, abstract_tree: Any,
                   fallbacks: list[str] | None = None) -> Any:
    """A :class:`NamedSharding` tree from (logical axes tree, a tree of
    tensors, ``meta`` ones included)."""
    return _zip_map(
        lambda ax, ab: rules.sharding_for(ax, tuple(ab.shape), fallbacks),
        axes_tree, abstract_tree,
    )


def shard_tensor(x: torch.Tensor, mesh, spec: Spec):
    """``x``, the same whole tensor on every rank, as a DTensor placed by
    ``spec`` on ``mesh``: each rank keeps its own slice, so nothing moves
    between ranks."""
    from torch.distributed.tensor import DTensor, Replicate

    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, placements(mesh, spec))


def shard_tree(rules: Rules, axes_tree: Any, tree: Any,
               fallbacks: list[str] | None = None) -> Any:
    """Every leaf of ``tree`` (the whole tensors, alike on every rank)
    placed on ``rules.mesh`` by its logical axes, as DTensors.  A
    ``ParamTree`` comes back as a ``ParamTree``, anything else as nested
    dicts / lists."""
    def one(ax, x):
        return shard_tensor(x.detach(), rules.mesh,
                            rules.spec_for(ax, tuple(x.shape), fallbacks))

    out = _zip_map(one, axes_tree, tree)
    if isinstance(tree, nn.Module):
        from ..models.base import ParamTree
        return ParamTree(out)
    return out
