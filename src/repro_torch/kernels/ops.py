"""Public entry points for the morph, Aug-Conv and decode-logits kernels.

``morph_rows`` and ``aug_conv_forward`` are the single-tenant steps of the
paper's own protocol: the provider morphs a batch of unrolled rows (K4,
:func:`~repro_torch.kernels.block_diag.block_diag_matmul`) and the
developer's first layer multiplies morphed rows by the fused Aug-Conv matrix
(K5, :func:`~repro_torch.kernels.aug_gemm.aug_gemm`).  ``morph_rows_batched``
and ``aug_conv_forward_batched`` launch the same kernels once over a group
axis with one secret per group, as the reference ``vmap``s K4/K5.

``morph_rows_grouped`` and ``aug_conv_forward_grouped`` are the two steps
of the engine's vision delivery hot path, ``lm_head_rows_grouped`` the
logits step of batched decode: per-group (per-row) secrets are read in
place from the stacked slot tables by :mod:`repro_torch.kernels.grouped`.

Every kernel masks its ragged edges, so these take any shape: there is no
tileability test and no route around a kernel on the card.  The activation
operand is made contiguous here; the secret operands must already be.

``token_morph_batched``, ``aug_embed_batched`` (one table per group),
``token_morph_grouped``, ``aug_embed_grouped`` and ``aug_embed_rows_grouped``
(slot-indexed) are gathers: torch advanced indexing on every device, as the
reference routes them to XLA's gather on every backend.
"""
from __future__ import annotations

import torch

from . import ref
from .gemm import refuse_dtensor
from .aug_gemm import aug_gemm
from .block_diag import block_diag_matmul
from .grouped import grouped_aug_gemm, grouped_block_diag_matmul, grouped_row_gemm

__all__ = [
    "morph_rows", "aug_conv_forward", "morph_rows_batched",
    "aug_conv_forward_batched", "token_morph_batched", "aug_embed_batched",
    "morph_rows_grouped", "aug_conv_forward_grouped", "token_morph_grouped",
    "aug_embed_grouped", "aug_embed_rows_grouped", "lm_head_rows_grouped",
]


def morph_rows(x: torch.Tensor, core: torch.Tensor, kappa: int) -> torch.Tensor:
    """Provider-side morphing: x (R, kappa*q) @ blockdiag(core) (K4)."""
    return block_diag_matmul(x.contiguous(), core, int(kappa))


def aug_conv_forward(t: torch.Tensor, c_ac: torch.Tensor) -> torch.Tensor:
    """Developer-side Aug-Conv layer: t (B, K) @ c_ac (K, N) (K5)."""
    return aug_gemm(t.contiguous(), c_ac)


def morph_rows_batched(x: torch.Tensor, cores: torch.Tensor,
                       kappa: int) -> torch.Tensor:
    """Per-group morphing: x (G, B, kappa*q) with cores (G, q, q), one K4
    launch over the group axis."""
    return block_diag_matmul(x.contiguous(), cores, int(kappa))


def aug_conv_forward_batched(t: torch.Tensor,
                             c_acs: torch.Tensor) -> torch.Tensor:
    """Per-group Aug-Conv forward: t (G, B, K) @ c_acs (G, K, N) -> (G, B, N),
    one K5 launch over the group axis."""
    return aug_gemm(t.contiguous(), c_acs)


def token_morph_batched(tokens: torch.Tensor,
                        perms: torch.Tensor) -> torch.Tensor:
    """Per-group token morphing: tokens (G, B, L) with perms (G, V) ->
    morphed (G, B, L)."""
    return ref.token_morph_batched_ref(tokens, perms)


def aug_embed_batched(tokens: torch.Tensor,
                      tables: torch.Tensor) -> torch.Tensor:
    """Per-group Aug-Embedding forward: morphed tokens (G, B, L) gathered
    from per-group (V, d) tables -> (G, B, L, d)."""
    return ref.aug_embed_batched_ref(tokens, tables)


def _safe_gidx(gidx, n_slots: int, device: torch.device) -> torch.Tensor:
    """Clamp slot indices into the stacked-secret range, as int32 on
    ``device``.

    Padding groups at the tail of a microbatch may carry an index past the
    slot table (the queue sees the group bucket, not the registry capacity).
    Padding rows are zero, so the result is zeros whoever's secret they hit.
    The kernel clamps again on its own: for it the clamp is memory safety.
    """
    return torch.as_tensor(gidx, device=device).to(torch.int32).clamp(
        0, n_slots - 1
    ).contiguous()


def morph_rows_grouped(
    x: torch.Tensor, gidx, cores: torch.Tensor, kappa: int
) -> torch.Tensor:
    """Slot-indexed morphing: x (G, B, kappa*q), gidx (G,), cores (S, q, q)."""
    refuse_dtensor("morph_rows_grouped", x, gidx, cores)
    return grouped_block_diag_matmul(
        x, _safe_gidx(gidx, cores.shape[0], x.device), cores, int(kappa)
    )


def aug_conv_forward_grouped(
    t: torch.Tensor, gidx, c_acs: torch.Tensor
) -> torch.Tensor:
    """Slot-indexed Aug-Conv forward: t (G, B, K), gidx (G,), c_acs (S, K, N)."""
    refuse_dtensor("aug_conv_forward_grouped", t, gidx, c_acs)
    return grouped_aug_gemm(t, _safe_gidx(gidx, c_acs.shape[0], t.device), c_acs)


def token_morph_grouped(tokens: torch.Tensor, gidx,
                        perms: torch.Tensor) -> torch.Tensor:
    """Slot-indexed token morphing: tokens (G, B, L), gidx (G,), perms (S, V)
    -> morphed (G, B, L); no (G, V) copy of the permutations."""
    refuse_dtensor("token_morph_grouped", tokens, gidx, perms)
    return ref.token_morph_grouped_ref(
        tokens, _safe_gidx(gidx, perms.shape[0], tokens.device), perms
    )


def aug_embed_grouped(tokens: torch.Tensor, gidx,
                      tables: torch.Tensor) -> torch.Tensor:
    """Slot-indexed Aug-Embedding: morphed tokens (G, B, L) gathered from the
    stacked (S, V, d) tables -> (G, B, L, d)."""
    refuse_dtensor("aug_embed_grouped", tokens, gidx, tables)
    return ref.aug_embed_grouped_ref(
        tokens, _safe_gidx(gidx, tables.shape[0], tokens.device), tables
    )


def aug_embed_rows_grouped(tokens: torch.Tensor, gidx,
                           tables: torch.Tensor) -> torch.Tensor:
    """Per-row slot-indexed AugE gather, the batched-decode embedding step:
    tokens (R,), gidx (R,), tables (S, V, d) -> (R, d)."""
    refuse_dtensor("aug_embed_rows_grouped", tokens, gidx, tables)
    return ref.aug_embed_rows_grouped_ref(
        tokens, _safe_gidx(gidx, tables.shape[0], tokens.device), tables
    )


def lm_head_rows_grouped(h: torch.Tensor, gidx,
                         heads: torch.Tensor) -> torch.Tensor:
    """Slot-indexed per-row LM-head GEMM, the batched-decode logits step:
    h (R, d), gidx (R,), heads (S, d, V) fp32 or bf16 -> (R, V)
    morphed-order logits in ``h.dtype`` (K3:
    :func:`~repro_torch.kernels.grouped.grouped_row_gemm`)."""
    refuse_dtensor("lm_head_rows_grouped", h, gidx, heads)
    return grouped_row_gemm(
        h.contiguous(), _safe_gidx(gidx, heads.shape[0], h.device), heads
    )
