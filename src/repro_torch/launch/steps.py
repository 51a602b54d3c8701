"""Step builders on PyTorch: the train step (microbatch gradient
accumulation, remat, AdamW) and the serving steps, prefill / decode, per
tenant and batched across tenants.

Ported from ``repro.launch.steps``.  The reference returns pure functions
for ``jax.jit``; these are the same functions run eagerly.  Caches are
written in place (see :mod:`repro_torch.models.blocks`) and returned; the
train step updates the parameters and optimizer state in place and returns
them.  The serving steps run under ``torch.no_grad()``, so they record no
autograd graph whatever the parameters' ``requires_grad``.

Under a mesh (:func:`repro_torch.launch.mesh.mesh_context`) the train step
runs SPMD, one process a rank: the parameters and AdamW moments are DTensors
(:func:`shard_train_state`: ``param_rules(fsdp=True)`` and
``opt_state_rules``); each microbatch splits its rows over the dp axes;
each rank runs the model on plain local tensors through
:func:`repro_torch.sharding.spmd.compute_view`: the head runs
vocab-parallel and MoE FFNs expert-parallel over "model", and every other
layer's weights are gathered whole one block at a time where it runs
(under remat, again for its backward), then computed alike on the ranks
of a "model" group; the loss is the mean over the dp ranks, and the
gradient accumulators are placed as their leaves.  Without a mesh none of
this runs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels.ops import aug_embed_rows_grouped, lm_head_rows_grouped
from ..models import blocks as B
from ..models import layers as L
from ..models import stack as S
from ..models.api import Model
from ..optim import adamw
from ..sharding import rules as R
from ..sharding import spmd
from ..sharding.hints import ambient_mesh, is_dtensor

__all__ = [
    "TrainHParams", "make_train_step", "shard_train_state",
    "make_prefill_step", "make_decode_step", "make_row_prefill_step",
    "make_batched_decode_logits", "make_batched_decode_step",
]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig
    )
    microbatch: int | None = None   # microbatch count: None = one shot
    remat: bool = True


def _split_micro(batch: dict, n_micro: int) -> dict:
    """Every input of the batch (tokens, targets, a vlm's patches, an
    audio model's frames) cut into ``n_micro`` microbatches along its
    first axis."""
    def rs(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: rs(v) for k, v in batch.items()}


@contextlib.contextmanager
def _grad_on(leaves):
    """Leaves require grad inside the block and go back to what they were
    however it ends, so a tree built for serving (``requires_grad=False``)
    leaves a train step without recording a graph on later calls."""
    before = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        yield
    finally:
        for p, r in zip(leaves, before):
            p.requires_grad_(r)


def _flat_axes(axes, prefix: str = "") -> dict:
    """Logical axes keyed by each leaf's dotted name (``adamw.named_leaves``
    spelling: ``"blocks.0.mix.wq"``)."""
    if isinstance(axes, tuple):
        return {prefix.rstrip("."): axes}
    items = axes.items() if isinstance(axes, dict) else enumerate(axes)
    return {n: a for k, v in items
            for n, a in _flat_axes(v, f"{prefix}{k}.").items()}


def shard_train_state(model: Model, params, opt_state: dict, mesh):
    """``(params, opt_state)`` placed on ``mesh`` as DTensors: the
    parameters by ``param_rules(mesh, fsdp=True)``, the AdamW moments by
    ``opt_state_rules(mesh)`` (so each moment is placed as its leaf); the
    count stays a plain tensor.  Every rank passes the same whole tensors
    and keeps its own slices."""
    axes = model.axes()
    params = R.shard_tree(R.param_rules(mesh, fsdp=True), axes, params)
    flat, rules = _flat_axes(axes), R.opt_state_rules(mesh)
    moments = {
        k: {n: R.shard_tensor(t, mesh, rules.spec_for(flat[n], t.shape))
            for n, t in opt_state[k].items()}
        for k in ("m", "v")
    }
    return params, dict(opt_state, **moments)


def _micro_inputs(params, mb: dict, mesh):
    """What the loss reads for one microbatch: the parameters and inputs as
    they are off a mesh; under one, the compute view of the DTensor
    parameters and this rank's rows (all of them, replicated, where they
    do not split over the dp ranks)."""
    if mesh is None:
        return params, mb
    split = spmd.rows_split(next(iter(mb.values())).shape[0], mesh)
    return (spmd.compute_view(params, mesh, rows_split=split),
            {k: spmd.local_rows(v, mesh) for k, v in mb.items()})


def _loss_of(loss, mesh):
    """The microbatch's loss: under a mesh the mean of the ranks' means
    over the dp axes (the microbatch splits into equal rows)."""
    return loss if mesh is None else spmd.mean_over_dp(loss, mesh)


def _like(g, p):
    """The gradient ``g`` placed as its leaf ``p`` (a no-op off a mesh)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, hp: TrainHParams):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, with
    ``metrics = {loss, grad_norm, lr}`` (0-dim fp32 tensors).

    ``params`` is the tree :meth:`Model.init` returns and ``opt_state``
    :func:`adamw.init_state`'s; both are updated in place.  With
    ``hp.microbatch`` = n > 1 the batch is cut into n microbatches along
    its first axis; each one's gradients (``torch.autograd.grad``) are
    summed in fp32 and divided by n, and the loss is the mean of theirs, as
    the reference's scan does (``.grad`` accumulation would sum in the
    parameters' type).  With one microbatch the gradients stay in the
    parameters' type; AdamW casts them to fp32.

    Every stack of the registry trains; an RWKV-6 time-mix takes its scan's
    gradient through :func:`repro_torch.kernels.wkv6.wkv6_scan` (K6 on
    flipped operands and two key-row scans).

    Under an ambient mesh ``params`` and ``opt_state`` are
    :func:`shard_train_state`'s and ``batch`` holds whole tensors (alike on
    every rank); the metrics come back whole.
    """

    def loss_fn(params, mb):
        return model.loss(params, mb, remat=hp.remat)

    def train_step(params, opt_state, batch):
        mesh = ambient_mesh()
        names, leaves = zip(*adamw.named_leaves(params))
        n_micro = hp.microbatch or 1
        with torch.enable_grad(), _grad_on(leaves):
            if n_micro > 1:
                micro = _split_micro(batch, n_micro)
                gsum = [torch.zeros_like(p, dtype=torch.float32)
                        if is_dtensor(p) else
                        torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for p in leaves]
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(n_micro):
                    loss = _loss_of(loss_fn(*_micro_inputs(
                        params, {k: v[i] for k, v in micro.items()}, mesh)),
                        mesh)
                    for a, g, p in zip(gsum, torch.autograd.grad(loss, leaves),
                                       leaves):
                        a.add_(_like(g, p))   # fp32 + the gradient's type
                    lsum = lsum + loss.detach()
                grads = [g.div_(n_micro) for g in gsum]
                loss = lsum / n_micro
            else:
                loss = _loss_of(loss_fn(*_micro_inputs(params, batch, mesh)),
                                mesh)
                grads = [_like(g, p) for g, p in
                         zip(torch.autograd.grad(loss, leaves), leaves)]
                loss = loss.detach()
        params, opt_state, metrics = adamw.apply(
            hp.optimizer, params, dict(zip(names, grads)), opt_state
        )
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(model: Model):
    """(params, batch, caches) -> (last-token logits, caches); a vlm's
    batch carries its ``patches``, an audio model's its ``frames`` (run
    through the encoder once), whose K/V the cross caches keep for the
    decode steps."""

    @torch.no_grad()
    def prefill_step(params, batch, caches):
        return model.prefill_with_cache(params, batch, caches)

    return prefill_step


def make_decode_step(model: Model):
    """(params, token (B,1), t, caches) -> (logits (B,1,V), caches)."""

    @torch.no_grad()
    def decode_step(params, token, t, caches):
        return model.decode(params, token, t, caches)

    return decode_step


def _check_plain_lm(model: Model, what: str) -> None:
    cfg = model.cfg
    if cfg.family == "audio" or cfg.frontend is not None:
        raise ValueError(
            f"{what} serves plain LM decode only (family={cfg.family!r}, "
            f"frontend={'set' if cfg.frontend else None}); use the "
            f"per-tenant prefill/decode steps for frontend/audio models"
        )


def _embed_scale(h: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.scale_embedding:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    return h


def make_row_prefill_step(model: Model):
    """Single-sequence prefill against *delivered* per-tenant artifacts.

    ``(params, aug_embed (V, d), aug_head (d, V), tokens (1, L), caches)
    -> (first sampled token (1,) int32, caches)``

    The continuous-batching admission step: ``params`` are the shared
    trunk weights, and the tenant's fused AugE table / Aug-head arrive as
    arguments.  Only the last position's logits are computed; the head
    product is a plain matmul in ``h.dtype``, as in the reference.
    """
    _check_plain_lm(model, "make_row_prefill_step")
    cfg = model.cfg

    @torch.no_grad()
    def row_prefill_step(params, aug_embed, aug_head, tokens, caches):
        rs = B.RunState(mode="full", write_cache=True)
        h = _embed_scale(aug_embed[tokens.long()].to(cfg.adtype), cfg)
        h, caches = S.apply_stack(params, h, cfg, rs, caches)
        h = L.norm(h[:, -1:], params["final_norm"], cfg.norm)
        logits = torch.matmul(h, aug_head.to(h.dtype))
        logits = L.softcap(logits.float(), cfg.final_softcap)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32), caches

    return row_prefill_step


def make_batched_decode_logits(model: Model):
    """The logits half of :func:`make_batched_decode_step`:
    ``(params, aug_embeds, aug_heads, sidx, tokens, t, caches) ->
    (fp32 logits (R, V) in each row's morphed vocab order, caches)``."""
    _check_plain_lm(model, "make_batched_decode_logits")
    cfg = model.cfg

    @torch.no_grad()
    def batched_decode_logits(params, aug_embeds, aug_heads, sidx, tokens, t,
                              caches):
        h0 = aug_embed_rows_grouped(tokens, sidx, aug_embeds)
        h = _embed_scale(h0.to(cfg.adtype), cfg)[:, None, :]
        # each row routes through an MoE FFN as a call of its own
        rs = B.RunState(mode="decode", t=t, row_calls=True)
        h, caches = S.apply_stack(params, h, cfg, rs, caches)
        h = L.norm(h, params["final_norm"], cfg.norm)[:, 0]
        logits = lm_head_rows_grouped(h, sidx, aug_heads)
        return L.softcap(logits.float(), cfg.final_softcap), caches

    return batched_decode_logits


def make_batched_decode_step(model: Model):
    """One greedy decode step for a whole cross-tenant row batch.

    ``(params, aug_embeds (S, V, d), aug_heads (S, d, V), sidx (R,),
    tokens (R,), t (R,), caches) -> (next tokens (R,) int32, caches)``

    Row ``r`` is one tenant sequence: its token embeds through slot
    ``sidx[r]``'s AugE table (a gather), the shared trunk runs over all rows
    as one batch with per-row positions ``t[r]`` (the reference vmaps a B=1
    step over rows; here the row axis is the batch axis of ``(R, ...)``
    caches whose ``pos`` is per row, and an MoE FFN routes each row as a
    call of one token, ``RunState.row_calls``, so no row is dropped
    whatever R is), and the logits come from the
    ``(R, d)``-row grouped GEMM against the stacked per-slot Aug-heads —
    K3, :func:`~repro_torch.kernels.ops.lm_head_rows_grouped`.
    """
    logits_fn = make_batched_decode_logits(model)

    @torch.no_grad()
    def batched_decode_step(params, aug_embeds, aug_heads, sidx, tokens, t,
                            caches):
        logits, caches = logits_fn(params, aug_embeds, aug_heads, sidx,
                                   tokens, t, caches)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return batched_decode_step
