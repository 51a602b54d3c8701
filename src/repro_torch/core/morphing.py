"""Data morphing (paper §3.2), PyTorch port of ``repro.core.morphing``.

The provider draws a secret invertible *core* ``M'`` of shape ``(q, q)`` and
conceptually scales it block-diagonally to ``M`` of shape ``(F, F)`` with
``F = alpha*m*m`` and ``kappa = F / q`` repeated blocks (paper eq. 3-4).  The
morphed data is ``T^r = D^r @ M``, computed as
``reshape(D^r, (kappa, q)) @ M'`` without materializing ``M``.

``make_core`` is the reference's numpy code verbatim: the same seed gives a
byte-equal secret in both packages.  ``morph``/``unmorph`` run on torch, on
the device of the rows they are given.

Core generation modes:
  * ``"orthogonal"`` (default): ``M'`` is a Haar-random orthogonal matrix
    (QR of a Gaussian), so ``M'^{-1} = M'^T`` exactly.
  * ``"uniform"``: the paper's literal construction — iid non-zero random
    entries, rejection-sampled to a condition-number bound.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .redact import describe_array

__all__ = ["MorphCore", "make_core", "morph", "unmorph", "materialize_M"]


@dataclasses.dataclass(frozen=True)
class MorphCore:
    """A secret morphing core and its exact inverse (held by the provider)."""

    matrix: np.ndarray      # (q, q)
    inverse: np.ndarray     # (q, q)
    kappa: int              # number of diagonal repetitions
    mode: str

    @property
    def q(self) -> int:
        return self.matrix.shape[0]

    @property
    def n_features(self) -> int:
        return self.q * self.kappa

    def __repr__(self) -> str:
        # Redacted: shapes + digest only — core contents are the secret.
        return (
            f"MorphCore(matrix={describe_array(self.matrix)}, "
            f"inverse={describe_array(self.inverse)}, "
            f"kappa={self.kappa}, mode={self.mode!r})"
        )


def make_core(
    seed: int | np.random.Generator,
    n_features: int,
    kappa: int,
    mode: str = "orthogonal",
    max_condition: float = 1e4,
    dtype=np.float32,
) -> MorphCore:
    """Draw a secret core ``M'`` with ``q = n_features / kappa`` (paper eq. 3)."""
    if n_features % kappa != 0:
        raise ValueError(
            f"kappa={kappa} must divide n_features={n_features} (paper eq. 3)"
        )
    q = n_features // kappa
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)

    if mode == "orthogonal":
        g = rng.standard_normal((q, q))
        qmat, r = np.linalg.qr(g)
        # Fix signs for a proper Haar draw and to keep the diagonal non-zero.
        qmat = qmat * np.sign(np.diag(r))[None, :]
        core = qmat.astype(np.float64)
        inv = core.T.copy()
    elif mode == "uniform":
        for _ in range(64):
            core = rng.uniform(0.1, 1.0, size=(q, q)) * rng.choice(
                [-1.0, 1.0], size=(q, q)
            )
            core = core / np.sqrt(q)  # keep columns ~unit-norm (paper Def. 1)
            if q == 1 or np.linalg.cond(core) < max_condition:
                break
        else:  # pragma: no cover - overwhelmingly unlikely
            raise RuntimeError("could not sample a well-conditioned core")
        core = core.astype(np.float64)
        inv = np.linalg.inv(core)
    else:
        raise ValueError(f"unknown core mode: {mode!r}")

    return MorphCore(
        matrix=core.astype(dtype),
        inverse=inv.astype(dtype),
        kappa=kappa,
        mode=mode,
    )


def morph(xr: torch.Tensor, core: MorphCore | torch.Tensor,
          kappa: int | None = None) -> torch.Tensor:
    """``T^r = D^r @ M`` without materializing ``M`` (paper eq. 2).

    ``xr``: (..., F) with ``F = kappa * q``.  Works for any batch rank.  A
    :class:`MorphCore` is moved to ``xr``'s device; a tensor core must
    already be there.
    """
    if isinstance(core, MorphCore):
        mat = torch.as_tensor(core.matrix, device=xr.device)
        k = core.kappa
    else:
        mat, k = core, kappa
    q = mat.shape[0]
    lead = xr.shape[:-1]
    blocks = xr.reshape(*lead, k, q)
    out = torch.matmul(blocks, mat.to(xr.dtype))
    return out.reshape(*lead, k * q)


def unmorph(tr: torch.Tensor, core: MorphCore) -> torch.Tensor:
    """``D^r = T^r @ M^{-1}`` — provider-side exact inverse."""
    return morph(tr, torch.as_tensor(core.inverse, device=tr.device), core.kappa)


def materialize_M(core: MorphCore) -> np.ndarray:
    """Explicit ``M`` (paper eq. 4) — for small-scale validation only."""
    F = core.n_features
    M = np.zeros((F, F), dtype=core.matrix.dtype)
    q = core.q
    for k in range(core.kappa):
        M[k * q : (k + 1) * q, k * q : (k + 1) * q] = core.matrix
    return M
