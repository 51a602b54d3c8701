"""Public entry points for the grouped delivery kernels.

``morph_rows_grouped`` and ``aug_conv_forward_grouped`` are the two steps
of the engine's delivery hot path: per-group secrets are read in place from
the stacked slot tables by :mod:`repro_torch.kernels.grouped`, for any
``B``, ``K`` and ``N`` (the CUDA kernel masks its ragged edges, so there is
no tileability test and no route around the kernel on the card).
"""
from __future__ import annotations

import torch

from .grouped import grouped_aug_gemm, grouped_block_diag_matmul

__all__ = ["morph_rows_grouped", "aug_conv_forward_grouped"]


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
    return grouped_block_diag_matmul(
        x, _safe_gidx(gidx, cores.shape[0], x.device), cores, int(kappa)
    )


def aug_conv_forward_grouped(
    t: torch.Tensor, gidx, c_acs: torch.Tensor
) -> torch.Tensor:
    """Slot-indexed Aug-Conv forward: t (G, B, K), gidx (G,), c_acs (S, K, N)."""
    return grouped_aug_gemm(t, _safe_gidx(gidx, c_acs.shape[0], t.device), c_acs)
