"""Augmented Convolutional (Aug-Conv) layer construction (paper §3.3).

PyTorch port of ``repro.core.aug_conv``.  ``C^{ac} = M^{-1} · C`` followed
by *feature channel randomization* — a secret permutation of the ``beta``
column groups (each group = ``n^2`` contiguous columns).  For morphed data
``T^r``:

    T^r · C^{ac} = D^r · C   (up to the secret output-channel permutation)

which is the paper's exact-equivalence property (eq. 5).

Construction stays on the host in numpy.  The fusion
``C^{ac}[kq:(k+1)q, :] = M'^{-1} @ C[kq:(k+1)q, :]`` is one float64 BLAS
matmul over the ``kappa`` blocks.  The reference computes the same sum with
an unoptimized ``np.einsum``, which at VGG-16/CIFAR width (3072 x 3072 x
65536 MACs per tenant) does not finish in minutes; the matmul takes seconds.
Only the summation order differs, so after the fp32 cast the two agree to
rtol 1e-6 (``tests/test_torch_core.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .d2r import ConvGeometry, conv_as_matrix
from .morphing import MorphCore

__all__ = [
    "AugConv",
    "random_channel_perm",
    "permute_channel_groups",
    "build_aug_conv",
    "apply_aug_conv",
]


@dataclasses.dataclass(frozen=True)
class AugConv:
    """The fused, permuted first-layer matrix shipped to the developer."""

    matrix: np.ndarray        # (alpha*m*m, beta*n*n)
    geom: ConvGeometry
    # The secret permutation is retained by the *provider* only; it is carried
    # here so tests / the trusted simulator can verify equivalence.  The
    # developer-facing artifact is `matrix` alone.
    channel_perm: np.ndarray  # (beta,) secret — provider-side record

    @property
    def n_elements(self) -> int:
        return self.matrix.size


def random_channel_perm(seed: int | np.random.Generator, beta: int) -> np.ndarray:
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    return rng.permutation(beta)


def permute_channel_groups(C: np.ndarray, perm: np.ndarray, n: int) -> np.ndarray:
    """Shuffle the ``beta`` groups of ``n^2`` contiguous columns (paper §3.3).

    Column group ``g`` of the result is column group ``perm[g]`` of the input,
    i.e. output channel ``g`` of the Aug-Conv layer carries what the original
    network called channel ``perm[g]``.
    """
    beta = C.shape[1] // (n * n)
    grouped = C.reshape(C.shape[0], beta, n * n)
    return grouped[:, perm, :].reshape(C.shape)


def build_aug_conv(
    kernels: np.ndarray,
    geom: ConvGeometry,
    core: MorphCore,
    perm_seed: int | np.random.Generator | np.ndarray = 0,
) -> AugConv:
    """Provider-side construction of ``C^{ac}`` (paper §3.3 steps 1-2 + rand)."""
    if core.n_features != geom.in_features:
        raise ValueError(
            f"morph core covers {core.n_features} features, layer expects "
            f"{geom.in_features}"
        )
    C = conv_as_matrix(kernels, geom).astype(np.float64)

    # Blockwise M^{-1} @ C  — M^{-1} is block-diag(inv core, ... kappa times).
    q = core.q
    blocks = C.reshape(core.kappa, q, geom.out_features)
    fused = np.matmul(core.inverse.astype(np.float64), blocks).reshape(
        geom.in_features, geom.out_features
    )

    if isinstance(perm_seed, np.ndarray):
        perm = perm_seed
    else:
        perm = random_channel_perm(perm_seed, geom.beta)
    fused = permute_channel_groups(fused, perm, geom.n)
    return AugConv(
        matrix=fused.astype(kernels.dtype), geom=geom, channel_perm=perm
    )


def apply_aug_conv(tr: torch.Tensor, aug: AugConv | torch.Tensor) -> torch.Tensor:
    """Developer-side forward: ``F'^r = T^r @ C^{ac}``.  (B, F_in) -> (B, F_out).

    An :class:`AugConv` is moved to ``tr``'s device; a tensor must already
    be there.
    """
    mat = (
        torch.as_tensor(aug.matrix, device=tr.device)
        if isinstance(aug, AugConv) else aug
    )
    return tr @ mat.to(tr.dtype)
