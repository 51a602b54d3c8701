"""Distribution substrate on ``torch.distributed``: logical-axis sharding
rules and activation hints, ported from ``repro.sharding``.

One program runs on one device or SPMD over a ``DeviceMesh``, one process
a rank, as the reference runs under ``jax.set_mesh``.  Nothing here runs
without a mesh.  How the reference's ideas map to torch:

=========================================  ==================================
Reference                                  Port
=========================================  ==================================
``jax.sharding.Mesh`` (axis names, sizes)  ``torch.distributed.device_mesh.
                                           DeviceMesh`` with
                                           ``mesh_dim_names``
``AbstractMesh`` (shape only)              :class:`rules.MeshShape`, so the
                                           rules run with no process group
``PartitionSpec`` per array dim            the same per-dim spec as a tuple;
                                           turned into DTensor placements
                                           (``Shard(d)`` / ``Replicate()``)
                                           a mesh dim only where a tensor is
                                           placed.  A dim on ("pod", "data")
                                           is ``Shard(d)`` on both mesh
                                           dims, split pod-major as JAX
                                           splits it (DTensor splits nested
                                           shards in mesh-dim order)
``NamedSharding`` / ``jax.device_put``     ``(mesh, placements)`` /
                                           :func:`rules.shard_tensor`
the ambient mesh (``jax.set_mesh``)        ``launch.mesh.mesh_context(mesh)``
                                           sets a ``contextvars`` variable
                                           that :func:`hints.hint`, the
                                           train step and the delivery
                                           engine read.  The MoE dispatcher
                                           reads its weights' placement
                                           instead (:mod:`spmd`)
``with_sharding_constraint``               ``DTensor.redistribute``
                                           (:func:`hints.hint`)
``shard_map`` + ``psum`` / ``all_gather``  ``to_local()`` and c10d
                                           collectives on
                                           ``mesh.get_group(name)``
=========================================  ==================================

The train step runs each rank's model on plain local tensors
(:mod:`spmd`), so no activation is a DTensor and the reference's hint
sites in the model, the steps and the engine have no counterpart:
:func:`hints.hint` acts on DTensors only, and is placed where a path first
produces DTensor activations.  The dp axes split the rows and, at rest,
the parameters and moments; "model" splits the LM head's vocab and the
MoE experts, and every other layer runs whole, alike on the ranks of a
"model" group.
"""
from . import rules
from .hints import hint
from .rules import delivery_rules

__all__ = ["rules", "hint", "delivery_rules"]
