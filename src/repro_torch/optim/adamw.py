"""AdamW with fp32 moments, global-norm clipping, warmup-cosine schedule.

Ported from ``repro.optim.adamw``, on trees of tensors: a
:class:`~repro_torch.models.base.ParamTree` (or nested dicts of tensors)
for the parameters, and flat dicts keyed by each leaf's dotted
name (``"blocks.0.mix.wq"``, as ``named_parameters`` gives it) for the
gradients and the moments.  The arithmetic is the reference's, expression
for expression, in fp32 whatever the parameter's type; only the storage
differs: :func:`apply` writes the new parameters and moments in place
instead of returning new arrays (a trainer holds one copy of each on the
card).  Under a mesh the leaves, gradients and moments are DTensors placed
alike, and each rank updates its own shards (the update is elementwise).
``torch.optim.AdamW`` is not this optimizer: it keeps its moments in
the parameter's type and applies the weight decay as a separate multiply.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..sharding.hints import is_dtensor

__all__ = ["AdamWConfig", "apply", "global_norm", "init_state", "lr_at",
           "named_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` for every leaf of ``tree``: an
    ``nn.Module`` (its ``named_parameters``), a dict, or a tensor."""
    if isinstance(tree, nn.Module):
        return [(prefix + n, p) for n, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("."), tree)]
    return [leaf for k, v in tree.items()
            for leaf in named_leaves(v, f"{prefix}{k}.")]


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at optimizer step ``step`` (an int or an integer
    tensor), as a 0-dim fp32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0, 1,
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac)
    )
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(params) -> dict:
    """Zero fp32 moments for every leaf (DTensor leaves get DTensor moments
    placed as they are), and ``count`` (int32, on the parameters' device)
    at 0."""
    leaves = named_leaves(params)
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p)
             else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in leaves}
    return {
        "m": zeros,
        "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0][1].device),
    }


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in fp32.  DTensor gradients
    (a mesh spanning the world) sum their local shards, each shard counted
    once however many ranks replicate it, and add over the world."""
    if any(is_dtensor(g) for g in grads.values()):
        import torch.distributed as dist

        total = sum(torch.sum(torch.square(g.to_local().float()))
                    / _replicas(g) for g in grads.values())
        dist.all_reduce(total)
        return torch.sqrt(total)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _replicas(g) -> int:
    """The ranks that hold each of a DTensor's shards."""
    from torch.distributed.tensor import Replicate

    return math.prod(g.device_mesh.size(i) for i, p in enumerate(g.placements)
                     if isinstance(p, Replicate))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads: dict, state: dict):
    """One AdamW step.  ``grads`` maps each leaf's dotted name (see
    :func:`named_leaves`) to its gradient.  Updates ``params`` and the
    moments in place; returns ``(params, state, metrics)`` with ``state``'s
    new ``count`` and ``metrics = {grad_norm, lr}`` (0-dim fp32 tensors)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    count = state["count"] + 1
    lr = lr_at(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    for name, p in named_leaves(params):
        ops = (p, state["m"][name], state["v"][name], grads[name])
        if is_dtensor(p):
            ops = _local_shards(name, *ops)
        for p_, m, v, g in _slices(*ops):
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            del g
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = p_.float()
            step = step + cfg.weight_decay * p32
            p_.copy_(p32 - lr * step)
    return params, dict(state, count=count), {"grad_norm": gnorm, "lr": lr}


def _local_shards(name: str, p, m, v, g) -> tuple:
    """A DTensor leaf's local shard with its moments' and gradient's (the
    gradient placed as the leaf first)."""
    pl = tuple(p.placements)
    if tuple(m.placements) != pl or tuple(v.placements) != pl:
        raise ValueError(f"{name}: moments placed {tuple(m.placements)}, "
                         f"the parameter {pl}")
    if tuple(g.placements) != pl:
        g = g.redistribute(p.device_mesh, pl)
    return p.to_local(), m.to_local(), v.to_local(), g.to_local()


SLICE = 1 << 26     # elements an update slice


def _slices(p, m, v, g):
    """A leaf's parameter, moments and gradient in flat slices of SLICE
    elements (one piece when it is smaller or not contiguous).  The update
    is elementwise, so each slice gets the bits the whole leaf would; the
    fp32 temporaries of one update (about four of the slice's size) stay
    under 1.1 GB where a 1.05 B-entry embedding would hold 17 GB."""
    n = p.numel()
    if n <= SLICE or not (p.is_contiguous() and m.is_contiguous()
                          and v.is_contiguous()):
        return [(p, m, v, g)]
    flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
    return [tuple(t[i:i + SLICE] for t in flat) for i in range(0, n, SLICE)]
