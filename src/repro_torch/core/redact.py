"""Redacted descriptions of secret-bearing arrays.

``repr`` of a tenant's permutation or morph core must never print array
contents — an accidental ``log.info(f"{sess}")`` or assertion message
would hand the tenant's key material to whoever reads the log.  These
helpers render an array as dtype, shape and a short content digest:
enough to tell two secrets apart or spot a corrupted one, nothing more.

The ``repro.analysis`` taint pass treats both helpers as sanitizers, so
a redacted ``__repr__`` built from them is a safe sink.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["short_digest", "describe_array"]


def short_digest(arr) -> str:
    """First 8 hex chars of a SHA-1 over the array bytes (stable id,
    not reversible to contents)."""
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha1(a.tobytes())
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    return h.hexdigest()[:8]


def describe_array(arr) -> str:
    """``float32(512, 512)#1a2b3c4d`` — dtype, shape, digest; no values."""
    if arr is None:
        return "None"
    a = np.asarray(arr)
    return f"{a.dtype.name}{a.shape}#{short_digest(a)}"
