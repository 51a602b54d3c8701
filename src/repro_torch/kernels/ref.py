"""Plain PyTorch versions of the port's CUDA kernels.

The CPU path of every wrapper in :mod:`repro_torch.kernels.grouped`, and the
versions ``chip_smoke.py`` holds the kernels against on the card.  They
repeat the reference's math (``repro.kernels.ref``): operands cast to fp32,
fp32 products, results cast back to the input dtype.  Grouped versions take
the ``(G,)`` slot-index vector and the stacked ``(S, ...)`` secrets and index
one slot per group (a view, no ``(G, ...)`` copy); slot indices clamp into
``[0, S-1]`` as the kernel clamps them.
"""
from __future__ import annotations

import torch

__all__ = [
    "block_diag_matmul_ref",
    "aug_gemm_ref",
    "block_diag_matmul_grouped_ref",
    "aug_gemm_grouped_ref",
]


def block_diag_matmul_ref(x: torch.Tensor, core: torch.Tensor,
                          kappa: int) -> torch.Tensor:
    """y = x @ blockdiag(core x kappa);  x: (R, kappa*q), core: (q, q)."""
    R, F = x.shape
    q = core.shape[0]
    blocks = x.reshape(R, kappa, q).float()
    out = torch.matmul(blocks, core.float())
    return out.reshape(R, F).to(x.dtype)


def aug_gemm_ref(t: torch.Tensor, c_ac: torch.Tensor) -> torch.Tensor:
    """t (B, K) @ c_ac (K, N) in fp32."""
    return torch.matmul(t.float(), c_ac.float()).to(t.dtype)


def _slots(gidx: torch.Tensor, n_slots: int) -> list[int]:
    return [min(max(int(i), 0), n_slots - 1) for i in gidx.tolist()]


def block_diag_matmul_grouped_ref(
    x: torch.Tensor, gidx: torch.Tensor, cores: torch.Tensor, kappa: int
) -> torch.Tensor:
    """Slot-indexed morphing: x (G, B, kappa*q), gidx (G,), cores (S, q, q)."""
    return torch.stack([
        block_diag_matmul_ref(x[g], cores[s], kappa)
        for g, s in enumerate(_slots(gidx, cores.shape[0]))
    ])


def aug_gemm_grouped_ref(
    t: torch.Tensor, gidx: torch.Tensor, c_acs: torch.Tensor
) -> torch.Tensor:
    """Slot-indexed Aug-Conv forward: t (G, B, K), gidx (G,), c_acs (S, K, N)."""
    return torch.stack([
        aug_gemm_ref(t[g], c_acs[s])
        for g, s in enumerate(_slots(gidx, c_acs.shape[0]))
    ])
