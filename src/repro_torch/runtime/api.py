"""Typed delivery front door: request/response descriptors for the engine.

Ported from ``repro.runtime.api``.  Every lane of the delivery plane is
addressed through one request type:

  * :class:`DeliveryRequest` — a frozen descriptor (tenant, payload, lane,
    delivery mode, priority, optional per-request deadline, metadata) that is
    **validated and normalized exactly once**, here, before it reaches a
    queue.
  * :class:`DeliveryResult` — the response: the delivered payload plus the
    per-request trace (submit/complete timestamps, queue depth at admission,
    priority) that the scheduling layer accounts against.

The descriptor has the reference's three lanes: the vision ``"rows"``
lane, the LM ``"tokens"`` lane (``deliver="tokens"`` for morphed tokens,
``"embed"`` for Aug-embedded features) and the LM continuous ``"features"``
lane (per-position features through the tenant's morph core and fused
projection).

Payloads stay numpy on the host until the engine stages a coalesced
microbatch on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from repro_torch.core.d2r import unroll_batch

__all__ = ["DeliveryRequest", "DeliveryResult", "LANES", "DELIVER_MODES",
           "admission_rows", "normalize"]


LANES = ("rows", "tokens", "features")
DELIVER_MODES = ("tokens", "embed")


@dataclasses.dataclass(frozen=True, eq=False)
class DeliveryRequest:
    """One tenant's typed ask against the delivery plane.

    Parameters
    ----------
    tenant_id:
        Registered tenant the payload belongs to (its secrets morph it).
    payload:
        ``lane="rows"``: images ``(b, alpha, m, m)`` or rows ``(b, F_in)``;
        ``lane="tokens"``: int token sequences ``(b, L)``;
        ``lane="features"``: per-position features ``(b, L, d_in)`` or rows
        ``(n, d_in)``.
    lane:
        Which delivery lane serves the payload: ``"rows"`` (vision),
        ``"tokens"`` (LM discrete), ``"features"`` (LM continuous).
    deliver:
        Tokens lane only — ``"tokens"`` redeems the morphed tokens,
        ``"embed"`` additionally runs the developer-side Aug-Embedding.
    priority:
        Within-tenant scheduling priority (higher dequeues first; FIFO
        within a level).  Does **not** buy share across tenants.
    deadline_ms:
        Per-request completion-deadline budget for the async front door; None
        defers to the engine-wide ``max_delay_ms``.
    metadata:
        Opaque caller annotations, carried through to the
        :class:`DeliveryResult` untouched.
    """

    tenant_id: str
    payload: Any
    lane: str = "rows"
    deliver: str = "tokens"
    priority: int = 0
    deadline_ms: float | None = None
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.lane not in LANES:
            raise ValueError(f"lane must be one of {LANES}, got {self.lane!r}")
        if self.deliver not in DELIVER_MODES:
            raise ValueError(
                f"deliver must be one of {DELIVER_MODES}, got {self.deliver!r}"
            )
        if self.lane != "tokens" and self.deliver != "tokens":
            raise ValueError(
                f"deliver={self.deliver!r} only applies to lane='tokens' "
                f"(got lane={self.lane!r})"
            )
        if isinstance(self.priority, bool) or not isinstance(self.priority, int):
            raise ValueError(f"priority must be an int, got {self.priority!r}")
        if self.deadline_ms is not None:
            dl = float(self.deadline_ms)
            if not dl > 0:
                raise ValueError(
                    f"deadline_ms must be positive (or None), got {dl}"
                )
            object.__setattr__(self, "deadline_ms", dl)
        # Snapshot the caller's mapping: the descriptor is frozen, its
        # metadata should be too (a shared mutable dict would alias state
        # across the trust boundary of the queue).
        object.__setattr__(self, "metadata", dict(self.metadata))


@dataclasses.dataclass(frozen=True, eq=False)
class DeliveryResult:
    """A completed request: the delivered payload + its scheduling trace."""

    request_id: int
    tenant_id: str
    lane: str
    deliver: str
    priority: int
    payload: np.ndarray
    submitted_at: float          # time.monotonic() at admission
    completed_at: float          # time.monotonic() when a flush published it
    queue_depth_at_submit: int   # engine-wide pending rows just before enqueue
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def latency_ms(self) -> float:
        """Admission-to-publication latency of this request."""
        return (self.completed_at - self.submitted_at) * 1e3


# ---------------------------------------------------------------------------
# normalization: one validation point for every lane
# ---------------------------------------------------------------------------

def _require_nonempty(req: DeliveryRequest, n: int, unit: str) -> None:
    """Reject zero-row payloads at the front door: an empty request has
    nothing to deliver, and downstream it would coalesce into a phantom
    "real" group of pure padding (``largest=0`` still rounds up to the
    1-row bucket) that wastes a group slot and skews the padding stats."""
    if n == 0:
        raise ValueError(
            f"empty payload for tenant {req.tenant_id!r} on lane "
            f"{req.lane!r}: a request must carry at least one {unit} "
            f"(zero-row submissions have nothing to deliver and would "
            f"poison microbatch coalescing)"
        )


def _normalize_rows(engine, req: DeliveryRequest) -> np.ndarray:
    reg = engine.registry
    if reg is None:
        raise ValueError("engine has no vision registry")
    if req.tenant_id not in reg:
        raise KeyError(f"unknown tenant {req.tenant_id!r}")
    data = np.asarray(req.payload, np.float32)
    g = reg.geom
    if data.ndim == 4:
        if data.shape[1:] != (g.alpha, g.m, g.m):
            raise ValueError(
                f"expected images (b, {g.alpha}, {g.m}, {g.m}), got {data.shape}"
            )
        _require_nonempty(req, data.shape[0], "image")
        return np.asarray(unroll_batch(data))
    if data.ndim == 2:
        _require_nonempty(req, data.shape[0], "row")
        return data
    raise ValueError(f"expected rank-2 rows or rank-4 images, got {data.shape}")


def _normalize_tokens(engine, req: DeliveryRequest) -> np.ndarray:
    reg = engine.lm_registry
    if reg is None:
        raise ValueError("engine has no LM registry")
    if req.tenant_id not in reg:
        raise KeyError(f"unknown LM tenant {req.tenant_id!r}")
    tokens = np.asarray(req.payload)
    if tokens.ndim != 2 or not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(
            f"expected int tokens of shape (b, L), got {tokens.dtype} "
            f"{tokens.shape}"
        )
    _require_nonempty(req, tokens.shape[0], "sequence")
    max_seq = engine.seq_buckets[-1]
    if tokens.shape[1] > max_seq:
        raise ValueError(
            f"request for tenant {req.tenant_id!r}: sequence length "
            f"{tokens.shape[1]} exceeds the largest seq bucket {max_seq}; "
            f"split the request into <= {max_seq}-token chunks, or "
            f"construct the engine with larger seq_buckets"
        )
    _require_nonempty(req, tokens.shape[1], "token per sequence")
    v = reg.vocab
    if tokens.min() < 0 or tokens.max() >= v:
        raise ValueError(f"token ids out of range [0, {v})")
    return tokens.astype(np.int32)


def _normalize_features(engine, req: DeliveryRequest) -> np.ndarray:
    if engine.embed_queue is None:
        raise ValueError("engine's LM registry has no continuous lane")
    if req.tenant_id not in engine.lm_registry:
        raise KeyError(f"unknown LM tenant {req.tenant_id!r}")
    data = np.asarray(req.payload, np.float32)
    d_in = engine.lm_registry.d_in
    if data.ndim not in (2, 3) or data.shape[-1] != d_in:
        raise ValueError(
            f"expected (..., {d_in}) features with rank 2 or 3, got {data.shape}"
        )
    _require_nonempty(req, int(np.prod(data.shape[:-1])), "position")
    return data


_NORMALIZERS = {
    "rows": _normalize_rows,
    "tokens": _normalize_tokens,
    "features": _normalize_features,
}


def normalize(request: DeliveryRequest, engine) -> DeliveryRequest:
    """Validate ``request`` against ``engine``'s registries and return a copy
    whose payload is the canonical ndarray its lane's queue stores.

    Pure per-request work with no engine-state mutation — the async front
    door runs it **outside** its lock so payload conversion never serializes
    submitters.  Lane/deliver/priority/deadline fields were already checked
    by the descriptor itself; this adds the engine-dependent payload checks
    (registry present, tenant known, shape/dtype/range valid).
    """
    if not isinstance(request, DeliveryRequest):
        raise TypeError(
            f"expected a DeliveryRequest, got {type(request).__name__} "
            f"(the legacy tenant_id+payload calling convention was removed)"
        )
    payload = _NORMALIZERS[request.lane](engine, request)
    return dataclasses.replace(request, payload=payload)


def admission_rows(request: DeliveryRequest) -> int:
    """Rows a *normalized* request occupies for admission/quota accounting
    (images for rows, sequences for tokens, positions for features)."""
    if request.lane == "features":
        # No reshape: a payload whose last dim is 0 still counts its
        # positions, and is refused later by normalization.
        return int(np.prod(request.payload.shape[:-1]))
    return int(request.payload.shape[0])
