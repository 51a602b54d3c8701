"""Length-prefixed frame codec for the network delivery front door (a copy
of ``repro.runtime.wire``: numpy and asyncio only, byte-equal frames).

``DeliveryRequest`` / ``DeliveryResult`` are one serialization layer away
from a wire protocol (ROADMAP: "a real network front door"); this module is
that layer.  It is deliberately dependency-free — plain ``struct`` framing,
JSON headers, raw ndarray bytes — so both sides of the wire (the asyncio
server in ``repro_torch.launch.server`` and the client fleet in
``repro_torch.launch.client``) share one codec and one failure taxonomy.

Frame layout (all integers big-endian)::

    +-------+------+------------+-------------+----------+-----------+
    | magic | kind | header_len | payload_len | header   | payload   |
    | 2B    | 1B   | u32        | u32         | JSON     | raw bytes |
    +-------+------+------------+-------------+----------+-----------+

Kinds:

  * ``KIND_REQ``  client -> server: one :class:`DeliveryRequest` plus the
    client-chosen correlation id ``rid`` (retries and hedges re-send under
    the **same** rid, which is what lets the server keep delivery
    exactly-once) and ``age_ms`` (time the request has already spent
    client-side — deadline propagation without trusting cross-host clocks).
  * ``KIND_RES``  server -> client: the delivered payload + trace fields.
  * ``KIND_REJ``  server -> client: a **typed** rejection (``REJECT_CODES``)
    — overload sheds, expired deadlines, drains, and malformed requests are
    protocol outcomes, not dropped connections.
  * ``KIND_BYE``  server -> client: graceful-drain notice; the stream ends
    after it.

Every malformed input raises :class:`ProtocolError` *promptly* — bad magic,
unknown kind, oversized or truncated frames, non-JSON headers, payload
bytes that don't match the declared dtype/shape.  :func:`read_frame` never
buffers more than ``max_frame_bytes`` and never spins on garbage: the
length prefix is validated before a single payload byte is read.  (A
*stalled* peer is indistinguishable from a slow one at this layer — the
caller owns read timeouts; see the server's per-connection
``read_timeout``.)
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import struct
from typing import Any, Mapping

import numpy as np

from .api import DeliveryRequest, DeliveryResult

__all__ = [
    "ProtocolError",
    "KIND_REQ", "KIND_RES", "KIND_REJ", "KIND_BYE",
    "REJECT_CODES", "DEFAULT_MAX_FRAME",
    "encode_frame", "read_frame",
    "encode_request", "decode_request",
    "encode_result", "decode_result", "WireResult",
    "encode_reject", "decode_reject", "WireReject",
    "encode_bye",
]


class ProtocolError(RuntimeError):
    """The byte stream violated the frame protocol (garbage, truncation,
    oversize, malformed header/payload).  The connection that produced it
    cannot be resynchronized and must be closed.

    Decode-side messages describe violations by type/length/offset only —
    never by echoing the malformed frame's bytes or header strings, which
    are attacker-controlled and may be reflected to other parties via
    reject frames or logs."""


MAGIC = b"ML"
_HEAD = struct.Struct(">2sBII")          # magic, kind, header_len, payload_len

KIND_REQ = 1
KIND_RES = 2
KIND_REJ = 3
KIND_BYE = 4
_KINDS = (KIND_REQ, KIND_RES, KIND_REJ, KIND_BYE)

# Typed rejection codes a client can dispatch on:
#   OVERLOADED  shed at the door (global pending cap or per-tenant admission
#               quota) — retry later, with backoff
#   EXPIRED     already past its deadline_ms on arrival — retrying the same
#               deadline is pointless
#   DRAINING    the server is shutting down gracefully — retry elsewhere /
#               after restart
#   INVALID     malformed request (unknown tenant, bad shape/dtype/lane) —
#               retrying identical bytes cannot succeed
#   FAILED      the engine failed this request after admission
REJECT_CODES = ("OVERLOADED", "EXPIRED", "DRAINING", "INVALID", "FAILED")

DEFAULT_MAX_FRAME = 64 * 1024 * 1024     # 64 MiB: caps reader memory per frame

# ndarray dtypes allowed over the wire: everything the delivery lanes emit
# (float rows/features, int tokens).  A whitelist, not np.dtype(anything) —
# object/void dtypes would allow pickle-shaped payloads through.
_WIRE_DTYPES = (
    "float32", "float64", "float16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "bool",
)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def encode_frame(kind: int, header: Mapping[str, Any],
                 payload: bytes = b"") -> bytes:
    """Serialize one frame.  Raises :class:`ProtocolError` on a non-JSON-able
    header or an unknown kind (catching producer bugs on the producer)."""
    if kind not in _KINDS:
        raise ProtocolError(f"unknown frame kind {kind!r}")
    try:
        hdr = json.dumps(dict(header), separators=(",", ":")).encode("utf-8")
    except (TypeError, ValueError) as e:
        raise ProtocolError(f"header is not JSON-able: {e}") from e
    return _HEAD.pack(MAGIC, kind, len(hdr), len(payload)) + hdr + payload


def _parse_head(head: bytes, max_frame_bytes: int) -> tuple[int, int, int]:
    magic, kind, hlen, plen = _HEAD.unpack(head)
    if magic != MAGIC:
        raise ProtocolError("bad magic (2-byte prefix is not a delivery frame)")
    if kind not in _KINDS:
        raise ProtocolError(f"unknown frame kind {kind}")
    if hlen + plen + _HEAD.size > max_frame_bytes:
        raise ProtocolError(
            f"oversized frame: {hlen + plen + _HEAD.size} bytes "
            f"> max_frame_bytes={max_frame_bytes}"
        )
    return kind, hlen, plen


def _parse_body(kind: int, hdr: bytes, payload: bytes) -> tuple[int, dict, bytes]:
    try:
        header = json.loads(hdr.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(
            f"frame header is not JSON ({type(e).__name__})"
        ) from e
    if not isinstance(header, dict):
        raise ProtocolError(
            f"frame header must be a JSON object, got {type(header).__name__}"
        )
    return kind, header, payload


def decode_frame(buf: bytes,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME) -> tuple[int, dict, bytes]:
    """Decode one complete frame from ``buf`` (must be exactly one frame) —
    the synchronous twin of :func:`read_frame`, used by tests."""
    if len(buf) < _HEAD.size:
        raise ProtocolError(
            f"truncated frame: {len(buf)} bytes < {_HEAD.size}-byte head"
        )
    kind, hlen, plen = _parse_head(buf[:_HEAD.size], max_frame_bytes)
    if len(buf) != _HEAD.size + hlen + plen:
        raise ProtocolError(
            f"frame length mismatch: have {len(buf)} bytes, "
            f"head declares {_HEAD.size + hlen + plen}"
        )
    hdr = buf[_HEAD.size:_HEAD.size + hlen]
    return _parse_body(kind, hdr, buf[_HEAD.size + hlen:])


async def read_frame(
    reader: asyncio.StreamReader,
    max_frame_bytes: int = DEFAULT_MAX_FRAME,
) -> tuple[int, dict, bytes] | None:
    """Read one frame from ``reader``.

    Returns ``None`` on clean EOF at a frame boundary (peer closed between
    frames); raises :class:`ProtocolError` on garbage, oversize, or
    truncation (EOF mid-frame).  Memory is bounded: the length prefix is
    validated against ``max_frame_bytes`` before the body is read.
    """
    try:
        head = await reader.readexactly(_HEAD.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None                       # clean EOF between frames
        raise ProtocolError(
            f"truncated frame head: got {len(e.partial)}/{_HEAD.size} bytes "
            f"before EOF"
        ) from e
    kind, hlen, plen = _parse_head(head, max_frame_bytes)
    try:
        hdr = await reader.readexactly(hlen)
        payload = await reader.readexactly(plen)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(
            f"truncated frame body: EOF after {len(e.partial)} of "
            f"{hlen + plen} bytes"
        ) from e
    return _parse_body(kind, hdr, payload)


# ---------------------------------------------------------------------------
# ndarray payloads
# ---------------------------------------------------------------------------

def _encode_array(arr: np.ndarray) -> tuple[dict, bytes]:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _WIRE_DTYPES:
        raise ProtocolError(
            f"dtype {arr.dtype.name!r} is not wire-transportable "
            f"(allowed: {_WIRE_DTYPES})"
        )
    return {"dtype": arr.dtype.name, "shape": list(arr.shape)}, arr.tobytes()


def _decode_array(header: Mapping[str, Any], payload: bytes) -> np.ndarray:
    dtype = header.get("dtype")
    shape = header.get("shape")
    if dtype not in _WIRE_DTYPES:
        raise ProtocolError(
            f"header dtype is not wire-transportable "
            f"(allowed: {_WIRE_DTYPES})"
        )
    if (
        not isinstance(shape, list)
        or not all(isinstance(d, int) and d >= 0 for d in shape)
    ):
        raise ProtocolError(
            f"bad payload shape (want a list of non-negative ints, "
            f"got {type(shape).__name__})"
        )
    dt = np.dtype(dtype)
    want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    if want != len(payload):
        raise ProtocolError(
            f"payload size mismatch: shape {shape} x {dtype} needs {want} "
            f"bytes, frame carries {len(payload)}"
        )
    return np.frombuffer(payload, dtype=dt).reshape(shape).copy()


# ---------------------------------------------------------------------------
# message schemas
# ---------------------------------------------------------------------------

def encode_request(req: DeliveryRequest, rid: str,
                   age_ms: float = 0.0) -> bytes:
    """Frame one request under the client correlation id ``rid``.

    ``age_ms`` is how long the request has already existed client-side
    (creation -> this send, retries included): the server adds its own
    elapsed time on top, so deadline expiry composes across hosts without
    comparing wall clocks.
    """
    payload = np.asarray(req.payload)
    meta, body = _encode_array(payload)
    header = {
        "rid": str(rid),
        "tenant": req.tenant_id,
        "lane": req.lane,
        "deliver": req.deliver,
        "priority": req.priority,
        "deadline_ms": req.deadline_ms,
        "age_ms": float(age_ms),
        "metadata": dict(req.metadata),
        **meta,
    }
    return encode_frame(KIND_REQ, header, body)


def decode_request(header: Mapping[str, Any],
                   payload: bytes) -> tuple[str, float, DeliveryRequest]:
    """Decode a ``KIND_REQ`` body -> ``(rid, age_ms, request)``.

    Frame-shape violations raise :class:`ProtocolError`; *semantic*
    violations (bad lane/priority/deadline combinations) surface as the
    descriptor's own ``ValueError`` — the server maps those to a typed
    ``INVALID`` rejection rather than closing the connection.
    """
    rid = header.get("rid")
    if not isinstance(rid, str) or not rid:
        raise ProtocolError(
            f"request frame without a rid (want str, got {type(rid).__name__})"
        )
    tenant = header.get("tenant")
    if not isinstance(tenant, str):
        raise ProtocolError(
            f"request frame without a tenant "
            f"(want str, got {type(tenant).__name__})"
        )
    age = header.get("age_ms", 0.0)
    if not isinstance(age, (int, float)) or isinstance(age, bool) or age < 0:
        raise ProtocolError(f"bad age_ms (got {type(age).__name__})")
    metadata = header.get("metadata", {})
    if not isinstance(metadata, dict):
        raise ProtocolError(f"bad metadata {type(metadata).__name__}")
    req = DeliveryRequest(
        tenant_id=tenant,
        payload=_decode_array(header, payload),
        lane=header.get("lane", "rows"),
        deliver=header.get("deliver", "tokens"),
        priority=header.get("priority", 0),
        deadline_ms=header.get("deadline_ms"),
        metadata=metadata,
    )
    return rid, float(age), req


@dataclasses.dataclass(frozen=True)
class WireResult:
    """Client-side view of a ``KIND_RES`` frame."""

    rid: str
    engine_rid: int              # server-side engine id (id-space continuity)
    tenant_id: str
    lane: str
    latency_ms: float            # server-side admission -> publish latency
    payload: np.ndarray
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def encode_result(rid: str, result: DeliveryResult) -> bytes:
    meta, body = _encode_array(np.asarray(result.payload))
    header = {
        "rid": str(rid),
        "engine_rid": int(result.request_id),
        "tenant": result.tenant_id,
        "lane": result.lane,
        "latency_ms": float(result.latency_ms),
        "metadata": dict(result.metadata),
        **meta,
    }
    return encode_frame(KIND_RES, header, body)


def decode_result(header: Mapping[str, Any], payload: bytes) -> WireResult:
    rid = header.get("rid")
    if not isinstance(rid, str) or not rid:
        raise ProtocolError(
            f"result frame without a rid (want str, got {type(rid).__name__})"
        )
    engine_rid = header.get("engine_rid")
    if not isinstance(engine_rid, int) or isinstance(engine_rid, bool):
        raise ProtocolError(
            f"bad engine_rid (got {type(engine_rid).__name__})"
        )
    return WireResult(
        rid=rid,
        engine_rid=engine_rid,
        tenant_id=str(header.get("tenant", "")),
        lane=str(header.get("lane", "rows")),
        latency_ms=float(header.get("latency_ms", 0.0)),
        payload=_decode_array(header, payload),
        metadata=header.get("metadata", {}) or {},
    )


@dataclasses.dataclass(frozen=True)
class WireReject:
    """Client-side view of a ``KIND_REJ`` frame: a typed terminal outcome."""

    rid: str
    code: str                    # one of REJECT_CODES
    message: str


def encode_reject(rid: str, code: str, message: str = "") -> bytes:
    if code not in REJECT_CODES:
        raise ProtocolError(f"unknown reject code {code!r}")
    return encode_frame(
        KIND_REJ, {"rid": str(rid), "code": code, "message": str(message)}
    )


def decode_reject(header: Mapping[str, Any]) -> WireReject:
    rid = header.get("rid")
    code = header.get("code")
    if not isinstance(rid, str) or not rid:
        raise ProtocolError(
            f"reject frame without a rid (want str, got {type(rid).__name__})"
        )
    if code not in REJECT_CODES:
        raise ProtocolError(
            f"unknown reject code (got {type(code).__name__} "
            f"of length {len(str(code))})"
        )
    return WireReject(rid=rid, code=code, message=str(header.get("message", "")))


def encode_bye(reason: str = "drain") -> bytes:
    return encode_frame(KIND_BYE, {"reason": str(reason)})
