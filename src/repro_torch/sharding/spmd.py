"""The explicit SPMD pieces of the train step under a mesh: each rank's rows
of a batch, the compute view of DTensor parameters, and the collectives
with hand-written backwards that tensor-parallel code needs around plain
local tensors (Megatron's "f" and "g", and the data-parallel mean).

The step runs every rank's model on plain local tensors, its own rows of
the batch, as the reference's ``shard_map`` bodies run on local shards:
DTensor's sharding propagation is not used inside the model, whose op by
op placement search costs far more than the model's own work at the
sizes the CPU tests run (``PERF.md`` §6).

What the mesh's axes split: the dp axes ("pod", "data") split the rows,
and the parameters and moments at rest (FSDP).  "model" splits the LM
head's vocab (:func:`repro_torch.models.stack.fused_ce`) and an MoE FFN's
experts (:func:`repro_torch.models.blocks.apply_moe`); every other layer
is gathered whole where it runs and computed alike on the ranks of a
"model" group.  The blocks are gathered one at a time
(:class:`Deferred`): under remat (the train step's default) the gathered
weights of a block are dropped after its forward and gathered again for
its backward, so one block is whole at a time.
"""
from __future__ import annotations

import math

import torch

from .rules import dp_axes

__all__ = ["Deferred", "SumGradOver", "SumOver", "compute_view", "dp_index",
           "in_use", "local_rows", "mean_over_dp", "rows_split"]


def dp_index(mesh) -> tuple[int, int]:
    """``(this rank's index, the count)`` over the dp axes, pod-major."""
    idx, n = 0, 1
    for name in dp_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        idx, n = idx * size + mesh.get_local_rank(name), n * size
    return idx, n


def rows_split(b: int, mesh) -> bool:
    """Whether a batch of ``b`` rows splits over the dp ranks."""
    return b % dp_index(mesh)[1] == 0


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``x`` (whole and alike on every rank): its share
    of the first dim split over the dp axes, or all of ``x`` where that
    does not divide (the reference's hint then drops the split, and the
    batch is replicated)."""
    i, n = dp_index(mesh)
    b = x.shape[0]
    if b % n:
        return x
    return x[i * (b // n):(i + 1) * (b // n)]


def _groups(mesh, names) -> list:
    return [mesh.get_group(n) for n in names]


class SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``.
    Where ranks compute the same thing before a split (the trunk replicated
    over "model") and different parts after it (each rank's vocab slice or
    experts), the gradient that comes back is each rank's part of the
    whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class SumOver(torch.autograd.Function):
    """The sum of ``x`` over ``group`` (all ranks get it); the backward is
    the identity.  Where each rank holds a partial result (its experts'
    share of a token's output), the sum is the whole, and each rank's
    gradient is the whole gradient of its part."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """The mean of ``x`` over ``groups`` (all ranks get it); the backward
    hands each rank its own share, ``g / n``, with no collective."""

    @staticmethod
    def forward(ctx, x, groups, n):
        import torch.distributed as dist

        ctx.n = n
        x = x.clone()
        for group in groups:
            dist.all_reduce(x, group=group)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def mean_over_dp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the dp ranks of each rank's ``x``."""
    dp = dp_axes(mesh)
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp)
    return _MeanOver.apply(x, _groups(mesh, dp), n)


def _is_moe(node) -> bool:
    return hasattr(node, "keys") and "router" in node.keys()


def _moe_split(node, mesh) -> bool:
    """An MoE FFN keeps its experts split over "model" (the expert-parallel
    form) where the reference's dispatcher takes its ``shard_map`` form:
    the mesh has a "model" axis and the expert count divides by its
    size."""
    names = mesh.mesh_dim_names
    return ("model" in names
            and node["wg"].shape[0] % mesh.size(names.index("model")) == 0)


class Deferred:
    """A block's DTensor parameters whose compute view is taken where the
    block runs (:func:`in_use`), so that a block's weights are whole only
    while it runs."""

    __slots__ = ("tree", "mesh", "moe_tp")

    def __init__(self, tree, mesh, moe_tp: bool):
        self.tree, self.mesh, self.moe_tp = tree, mesh, moe_tp


def in_use(p):
    """A block's parameters for use: a :class:`Deferred` block's compute
    view (gathered now), any other tree as it is."""
    if isinstance(p, Deferred):
        return _view(p.tree, p.mesh, p.moe_tp, defer=False)
    return p


_STACKS = ("blocks", "enc_blocks")   # per-layer lists, gathered a layer at a time


def _view(params, mesh, moe_tp: bool, defer: bool):
    from torch.distributed.tensor import Partial, Replicate

    dp = {mesh.mesh_dim_names.index(a) for a in dp_axes(mesh)}

    def tp(p):
        want = [Replicate() if i in dp else pl
                for i, pl in enumerate(p.placements)]
        return p.redistribute(mesh, want)

    def whole(p):
        return p.full_tensor(grad_placements=[
            Partial() if i in dp else Replicate() for i in range(mesh.ndim)])

    def walk(node, path, explicit):
        if isinstance(node, torch.Tensor):
            return tp(node) if explicit else whole(node)
        if isinstance(node, (list, tuple, torch.nn.ModuleList)):
            return [walk(v, path + (i,), explicit)
                    for i, v in enumerate(node)]
        explicit = explicit or (moe_tp and _is_moe(node)
                                and _moe_split(node, mesh))
        return {k: [Deferred(b, mesh, moe_tp) for b in node[k]]
                if defer and k in _STACKS else
                walk(node[k], path + (k,), explicit or k == "head")
                for k in node.keys()}

    return walk(params, (), False)


def compute_view(params, mesh, rows_split: bool = True):
    """The parameters as a rank computes with them, as nested dicts / lists
    (differentiable, so the gradients reach the DTensor leaves).  The head
    keeps its tensor-parallel placement (the dp axes gathered) for the
    vocab-parallel cross-entropy, and so does an MoE FFN whose experts
    split over "model" while the rows split over the dp axes
    (``rows_split``): its expert-parallel form reads it.  Every other leaf
    is gathered whole (an MoE FFN then runs its dense form, as the
    reference's dispatcher falls back); the ranks of a "model" group then
    compute the same thing, and each dp rank's gradient is a partial sum.
    The layers of ``"blocks"`` and ``"enc_blocks"`` come back as
    :class:`Deferred`, gathered where they run."""
    return _view(params, mesh, rows_split, defer=True)
