"""Serving step builders on PyTorch: prefill / decode, per tenant and
batched across tenants.

Ported from ``repro.launch.steps`` (the serving half; the train step comes
with the training slice).  The reference returns pure functions for
``jax.jit``; these are the same functions run eagerly.  Caches are written
in place (see :mod:`repro_torch.models.blocks`) and returned.
"""
from __future__ import annotations

import torch

from ..kernels.ops import aug_embed_rows_grouped, lm_head_rows_grouped
from ..models import blocks as B
from ..models import layers as L
from ..models import stack as S
from ..models.api import Model

__all__ = [
    "make_prefill_step", "make_decode_step", "make_row_prefill_step",
    "make_batched_decode_logits", "make_batched_decode_step",
]


def make_prefill_step(model: Model):
    """(params, batch, caches) -> (last-token logits, caches)."""

    def prefill_step(params, batch, caches):
        return model.prefill_with_cache(params, batch, caches)

    return prefill_step


def make_decode_step(model: Model):
    """(params, token (B,1), t, caches) -> (logits (B,1,V), caches)."""

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

    def batched_decode_logits(params, aug_embeds, aug_heads, sidx, tokens, t,
                              caches):
        h0 = aug_embed_rows_grouped(tokens, sidx, aug_embeds)
        h = _embed_scale(h0.to(cfg.adtype), cfg)[:, None, :]
        rs = B.RunState(mode="decode", t=t)
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
    caches whose ``pos`` is per row), and the logits come from the
    ``(R, d)``-row grouped GEMM against the stacked per-slot Aug-heads —
    K3, :func:`~repro_torch.kernels.ops.lm_head_rows_grouped`.
    """
    logits_fn = make_batched_decode_logits(model)

    def batched_decode_step(params, aug_embeds, aug_heads, sidx, tokens, t,
                            caches):
        logits, caches = logits_fn(params, aug_embeds, aug_heads, sidx,
                                   tokens, t, caches)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return batched_decode_step
