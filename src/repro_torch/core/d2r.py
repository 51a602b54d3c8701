"""d2r — data-to-row-vector unrolling and conv-as-matrix construction.

PyTorch port of ``repro.core.d2r`` (paper §3.1).  The first convolutional
layer is rewritten as a single matrix ``C`` of shape
``(alpha*m*m, beta*n*n)`` so that

    F^r = D^r @ C

where ``D^r`` is the row-major unrolled input (channels outermost) and ``F^r``
unrolls the output features the same way.

``conv_as_matrix`` stays numpy and is the reference's code verbatim, so both
packages build byte-equal matrices from the same kernels.  The unroll/reroll
helpers are plain reshapes and work on torch tensors and numpy arrays alike.
``conv_reference`` is ``F.conv2d`` with cuDNN's TF32 off: the reference
convolution is full fp32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "ConvGeometry",
    "unroll",
    "unroll_batch",
    "reroll",
    "reroll_batch",
    "conv_as_matrix",
    "conv_reference",
    "d2r_conv_apply",
]


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Static geometry of the first convolutional layer."""

    alpha: int  # input channels
    beta: int   # output channels
    m: int      # input spatial size (m x m)
    p: int      # kernel size (p x p)
    stride: int = 1
    padding: int | None = None  # None => SAME-style (p-1)//2, the paper's eq. (1)

    @property
    def pad(self) -> int:
        return (self.p - 1) // 2 if self.padding is None else self.padding

    @property
    def n(self) -> int:
        """Output spatial size."""
        return (self.m + 2 * self.pad - self.p) // self.stride + 1

    @property
    def in_features(self) -> int:
        return self.alpha * self.m * self.m

    @property
    def out_features(self) -> int:
        return self.beta * self.n * self.n


def unroll(d):
    """``(alpha, m, m) -> (alpha*m*m,)`` row-major, channels outermost."""
    return d.reshape(-1)


def unroll_batch(d):
    """``(B, alpha, m, m) -> (B, alpha*m*m)``."""
    return d.reshape(d.shape[0], -1)


def reroll(fr, channels: int, size: int):
    """Inverse of :func:`unroll` for features: ``(beta*n*n,) -> (beta, n, n)``."""
    return fr.reshape(channels, size, size)


def reroll_batch(fr, channels: int, size: int):
    return fr.reshape(fr.shape[0], channels, size, size)


def conv_as_matrix(kernels: np.ndarray, geom: ConvGeometry) -> np.ndarray:
    """Build the d2r matrix ``C`` (paper eq. (1), generalized).

    ``kernels`` has shape ``(alpha, beta, p, p)``.  Returns ``C`` with shape
    ``(alpha*m*m, beta*n*n)`` such that ``unroll(D) @ C == unroll(conv(D, K))``.

    The paper's index map (stride 1, SAME, odd ``p``)::

        x = n^2 j + n c + d
        y = m^2 i + m (c + a - 1) + (d + b - 1)

    generalizes with stride ``s`` and padding ``o`` to::

        y = m^2 i + m (s c + a - o) + (s d + b - o)

    entries falling outside ``[0, m)`` in either spatial coordinate are dropped
    (they correspond to zero padding).
    """
    kernels = np.asarray(kernels)
    alpha, beta, p, _ = kernels.shape
    assert (alpha, p) == (geom.alpha, geom.p), (kernels.shape, geom)
    assert beta == geom.beta
    m, n, s, o = geom.m, geom.n, geom.stride, geom.pad

    # Broadcast the full index space (i, j, c, d, a, b).
    i = np.arange(alpha)[:, None, None, None, None, None]
    j = np.arange(beta)[None, :, None, None, None, None]
    c = np.arange(n)[None, None, :, None, None, None]
    d = np.arange(n)[None, None, None, :, None, None]
    a = np.arange(p)[None, None, None, None, :, None]
    b = np.arange(p)[None, None, None, None, None, :]

    row_in = s * c + a - o          # input row hit by (output row c, kernel row a)
    col_in = s * d + b - o
    valid = (row_in >= 0) & (row_in < m) & (col_in >= 0) & (col_in < m)

    x = n * n * j + n * c + d
    y = m * m * i + m * row_in + col_in

    full = (alpha, beta, n, n, p, p)
    vals = np.broadcast_to(kernels[:, :, None, None, :, :], full)
    valid = np.broadcast_to(valid, full)
    x = np.broadcast_to(x, full)[valid]
    y = np.broadcast_to(y, full)[valid]
    v = vals[valid]

    C = np.zeros((geom.in_features, geom.out_features), dtype=kernels.dtype)
    C[y, x] = v  # index pairs are unique: (i,a,b) -> y injective for fixed (c,d)
    return C


def conv_reference(data: torch.Tensor, kernels: torch.Tensor,
                   geom: ConvGeometry) -> torch.Tensor:
    """Oracle: direct convolution via ``F.conv2d``, TF32 off.

    ``data``: (B, alpha, m, m); ``kernels``: (alpha, beta, p, p).
    Returns (B, beta, n, n).
    """
    w = kernels.permute(1, 0, 2, 3)  # OIHW
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(data, w, stride=geom.stride, padding=geom.pad)


def d2r_conv_apply(data: torch.Tensor, C: torch.Tensor,
                   geom: ConvGeometry) -> torch.Tensor:
    """Apply a convolution through its d2r matrix. (B, a, m, m) -> (B, b, n, n)."""
    fr = unroll_batch(data) @ C
    return reroll_batch(fr, geom.beta, geom.n)
