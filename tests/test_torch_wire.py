"""The port's frame codec (``repro_torch.runtime.wire``) beside the
reference's (``repro.runtime.wire``).

Every frame the port encodes is byte-equal to the reference's for the same
input, and each package decodes the other's frames.  The codec's own
contract is held as ``tests/test_wire.py`` holds the reference's: round
trips over every message kind and wire dtype, and the failure taxonomy
(truncated, garbage and oversized frames raise a typed ``ProtocolError``
promptly, and no error message echoes attacker-controlled bytes).
"""
import asyncio
import json
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.runtime import wire as jwire  # noqa: E402
from repro.runtime.api import (  # noqa: E402
    DeliveryRequest as JRequest, DeliveryResult as JResult,
)
from repro_torch.runtime import wire  # noqa: E402
from repro_torch.runtime.api import DeliveryRequest, DeliveryResult  # noqa: E402
from repro_torch.runtime.wire import ProtocolError  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402


def _feed(data: bytes, eof: bool = True) -> asyncio.StreamReader:
    # Must run inside a loop: StreamReader binds the current event loop.
    r = asyncio.StreamReader()
    r.feed_data(data)
    if eof:
        r.feed_eof()
    return r


def _read(data: bytes, eof: bool = True, **kw):
    async def go():
        return await wire.read_frame(_feed(data, eof), **kw)

    return asyncio.run(go())


def _result_pair(**kw):
    fields = dict(
        request_id=42, tenant_id="tenant-3", lane="rows", deliver="tokens",
        priority=1, payload=np.ones((4, 7), np.float32),
        submitted_at=10.0, completed_at=10.004, queue_depth_at_submit=9,
        metadata={"trace": True},
    )
    fields.update(kw)
    return DeliveryResult(**fields), JResult(**fields)


# ---------------------------------------------------------------------------
# byte-equal to the reference, both directions
# ---------------------------------------------------------------------------

_REQUESTS = {
    "rows": dict(payload=np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2),
                 priority=2, deadline_ms=40.0, metadata={"k": "v", "n": 3}),
    "tokens_embed": dict(payload=np.array([[1, 2, 3], [4, 5, 6]], np.int32),
                         lane="tokens", deliver="embed"),
    "features": dict(payload=np.zeros((2, 5, 3), np.float64), lane="features"),
}


@pytest.mark.parametrize("case", sorted(_REQUESTS))
def test_request_frames_byte_equal_to_reference(case):
    kw = dict(_REQUESTS[case])
    payload = kw.pop("payload")
    frame = wire.encode_request(
        DeliveryRequest("tenant-1", payload, **kw), "r-7", age_ms=12.5
    )
    want = jwire.encode_request(
        JRequest("tenant-1", payload, **kw), "r-7", age_ms=12.5
    )
    assert frame == want
    # Each side decodes the other's frame to the same descriptor.
    jrid, jage, jreq = jwire.decode_request(*jwire.decode_frame(frame)[1:])
    rid, age, req = wire.decode_request(*wire.decode_frame(want)[1:])
    assert (rid, age) == (jrid, jage) == ("r-7", 12.5)
    for f in ("tenant_id", "lane", "deliver", "priority", "deadline_ms",
              "metadata"):
        assert getattr(req, f) == getattr(jreq, f)
    np.testing.assert_array_equal(req.payload, jreq.payload)
    assert req.payload.dtype == jreq.payload.dtype == payload.dtype


def test_result_reject_bye_frames_byte_equal_to_reference():
    tres, jres = _result_pair()
    assert wire.encode_result("r-9", tres) == jwire.encode_result("r-9", jres)
    for code in wire.REJECT_CODES:
        assert (wire.encode_reject("x-1", code, "why")
                == jwire.encode_reject("x-1", code, "why"))
    assert wire.encode_bye("drain") == jwire.encode_bye("drain")
    assert wire.encode_frame(wire.KIND_BYE, {"a": [1, 2.5, None]}, b"xy") == (
        jwire.encode_frame(jwire.KIND_BYE, {"a": [1, 2.5, None]}, b"xy")
    )
    assert (wire.REJECT_CODES, wire.DEFAULT_MAX_FRAME, wire._WIRE_DTYPES) == (
        jwire.REJECT_CODES, jwire.DEFAULT_MAX_FRAME, jwire._WIRE_DTYPES
    )
    assert (wire.KIND_REQ, wire.KIND_RES, wire.KIND_REJ, wire.KIND_BYE) == (
        jwire.KIND_REQ, jwire.KIND_RES, jwire.KIND_REJ, jwire.KIND_BYE
    )


@settings(max_examples=40, deadline=None)
@given(
    shape=st.lists(st.integers(0, 5), min_size=1, max_size=4),
    dtype=st.sampled_from(["float32", "int32", "uint8", "float16", "bool",
                           "int64", "float64"]),
    rid=st.text(min_size=1, max_size=32),
    metadata=st.dictionaries(
        st.text(max_size=8),
        st.one_of(st.integers(-10, 10), st.text(max_size=8), st.booleans()),
        max_size=4,
    ),
    age=st.floats(0, 1e6, allow_nan=False),
    seed=st.integers(0, 2**16),
)
def test_frames_byte_equal_property(shape, dtype, rid, metadata, age, seed):
    """Any wire dtype/shape/metadata/rid/age: the port's request frame is
    the reference's, byte for byte, and round-trips bit-exactly."""
    payload = (np.random.default_rng(seed).standard_normal(shape) * 7).astype(
        dtype
    )
    frame = wire.encode_request(
        DeliveryRequest("t", payload, metadata=metadata), rid, age_ms=age
    )
    assert frame == jwire.encode_request(
        JRequest("t", payload, metadata=metadata), rid, age_ms=age
    )
    out_rid, out_age, out = wire.decode_request(*wire.decode_frame(frame)[1:])
    assert out_rid == rid and out_age == pytest.approx(age)
    assert out.metadata == metadata and out.payload.dtype == payload.dtype
    np.testing.assert_array_equal(out.payload, payload)


# ---------------------------------------------------------------------------
# round trips through the stream reader
# ---------------------------------------------------------------------------

def test_request_roundtrip_rows_through_reader():
    kw = dict(_REQUESTS["rows"])
    payload = kw.pop("payload")
    req = DeliveryRequest("tenant-1", payload, **kw)
    rid, age, out = wire.decode_request(
        *_read(wire.encode_request(req, "r-7", age_ms=12.5))[1:]
    )
    assert rid == "r-7" and age == 12.5
    assert (out.tenant_id, out.lane, out.priority, out.deadline_ms) == (
        "tenant-1", "rows", 2, 40.0
    )
    assert out.metadata == {"k": "v", "n": 3}
    np.testing.assert_array_equal(out.payload, payload)


def test_result_roundtrip():
    res, _ = _result_pair()
    out = wire.decode_result(*_read(wire.encode_result("r-9", res))[1:])
    assert out.rid == "r-9" and out.engine_rid == 42
    assert out.tenant_id == "tenant-3" and out.lane == "rows"
    assert out.latency_ms == pytest.approx(4.0)
    assert out.metadata == {"trace": True}
    np.testing.assert_array_equal(out.payload, res.payload)


@pytest.mark.parametrize("code", ["OVERLOADED", "EXPIRED", "DRAINING",
                                  "INVALID", "FAILED"])
def test_reject_roundtrip(code):
    kind, header, payload = _read(wire.encode_reject("x-1", code, "why"))
    assert kind == wire.KIND_REJ and payload == b""
    rej = wire.decode_reject(header)
    assert (rej.rid, rej.code, rej.message) == ("x-1", code, "why")


def test_bye_and_multiframe_stream():
    buf = wire.encode_reject("a", "OVERLOADED") + wire.encode_bye("drain")

    async def drain():
        reader = _feed(buf)
        frames = []
        while (f := await wire.read_frame(reader)) is not None:
            frames.append(f)
        return frames

    frames = asyncio.run(drain())
    assert [k for k, _, _ in frames] == [wire.KIND_REJ, wire.KIND_BYE]
    assert frames[1][1]["reason"] == "drain"


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64", "int8",
                                   "int32", "int64", "uint8", "bool"])
def test_array_roundtrip_dtypes(dtype, rng):
    arr = (rng.standard_normal((3, 5)) * 10).astype(dtype)
    hdr, body = wire._encode_array(arr)
    assert (hdr, body) == jwire._encode_array(arr)
    out = wire._decode_array(hdr, body)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


# ---------------------------------------------------------------------------
# failure taxonomy: every malformed stream is a typed, prompt error
# ---------------------------------------------------------------------------

def test_clean_eof_returns_none():
    assert _read(b"") is None


_BAD_STREAMS = {
    "truncated frame head": b"ML\x01",
    "truncated frame body": wire.encode_reject("r", "FAILED", "boom")[:-3],
    "bad magic": b"XX" + b"\x01" + struct.pack(">II", 2, 0) + b"{}",
    "unknown frame kind": b"ML" + b"\x77" + struct.pack(">II", 2, 0) + b"{}",
    "not JSON": (struct.pack(">2sBII", b"ML", wire.KIND_BYE, 4, 0)
                 + b"\xff\xfe\x00\x01"),
    "JSON object": (struct.pack(">2sBII", b"ML", wire.KIND_BYE, 6, 0)
                    + json.dumps([1, 2]).encode()),
}


@pytest.mark.parametrize("match", sorted(_BAD_STREAMS))
def test_malformed_stream_raises_typed(match):
    with pytest.raises(ProtocolError, match=match):
        _read(_BAD_STREAMS[match])


def test_oversized_frame_rejected_before_body_is_read():
    # The declared body never arrives (no EOF fed) — the reader must still
    # fail promptly from the length prefix alone, without buffering.
    head = struct.pack(">2sBII", b"ML", wire.KIND_REQ, 16, 1 << 30)

    async def attempt():
        reader = _feed(head, eof=False)
        return await asyncio.wait_for(
            wire.read_frame(reader, max_frame_bytes=1 << 20), timeout=5.0
        )

    with pytest.raises(ProtocolError, match="oversized frame"):
        asyncio.run(attempt())
    frame = wire.encode_request(
        DeliveryRequest("t", np.zeros((4, 9), np.float32)), "r"
    )
    with pytest.raises(ProtocolError, match="oversized frame"):
        _read(frame, max_frame_bytes=64)


def test_payload_checks():
    with pytest.raises(ProtocolError, match="payload size mismatch"):
        wire._decode_array({"dtype": "float32", "shape": [2, 2]}, b"\x00" * 15)
    with pytest.raises(ProtocolError, match="not wire-transportable"):
        wire._decode_array({"dtype": "object", "shape": [1]}, b"\x00" * 8)
    with pytest.raises(ProtocolError, match="not wire-transportable"):
        wire._encode_array(np.array([object()]))
    with pytest.raises(ProtocolError, match="bad payload shape"):
        wire._decode_array({"dtype": "float32", "shape": [-1]}, b"")


def test_request_header_checks():
    with pytest.raises(ProtocolError, match="without a rid"):
        wire.decode_request({"tenant": "t", "dtype": "float32",
                             "shape": [1, 1]}, b"\x00" * 4)
    with pytest.raises(ProtocolError, match="without a tenant"):
        wire.decode_request({"rid": "r", "dtype": "float32",
                             "shape": [1, 1]}, b"\x00" * 4)
    frame = wire.encode_request(
        DeliveryRequest("t", np.zeros((1, 4), np.float32)), "r"
    )
    _, header, payload = wire.decode_frame(frame)
    # Bad lane combinations are the descriptor's own ValueError: the server
    # maps those to a typed INVALID rejection instead of closing the stream.
    with pytest.raises(ValueError, match="deliver"):
        wire.decode_request(dict(header, deliver="embed"), payload)
    with pytest.raises(ProtocolError, match="bad age_ms"):
        wire.decode_request(dict(header, age_ms=-5.0), payload)
    with pytest.raises(ProtocolError, match="bad metadata"):
        wire.decode_request(dict(header, metadata=[1]), payload)


def test_result_and_reject_header_checks():
    res, _ = _result_pair()
    _, header, payload = wire.decode_frame(wire.encode_result("r", res))
    with pytest.raises(ProtocolError, match="without a rid"):
        wire.decode_result(dict(header, rid=""), payload)
    with pytest.raises(ProtocolError, match="bad engine_rid"):
        wire.decode_result(dict(header, engine_rid=True), payload)
    with pytest.raises(ProtocolError, match="unknown reject code"):
        wire.decode_reject({"rid": "r", "code": "MAYBE"})
    with pytest.raises(ProtocolError, match="unknown reject code"):
        wire.encode_reject("r", "MAYBE")


def test_encode_frame_rejects_bad_producer_input():
    with pytest.raises(ProtocolError, match="unknown frame kind"):
        wire.encode_frame(99, {})
    with pytest.raises(ProtocolError, match="not JSON-able"):
        wire.encode_frame(wire.KIND_BYE, {"x": object()})


def test_protocol_errors_never_echo_frame_bytes():
    """Decode-side ProtocolError text describes violations by type/length
    only: a crafted frame's bytes and header strings are attacker-controlled
    and must never be reflected into reject frames or logs."""
    marker = "SECRETPAYLOADBYTES"
    bmarker = marker.encode()
    with pytest.raises(ProtocolError) as ei:
        wire.decode_frame(b"XY" + bytes(9))
    assert "XY" not in str(ei.value)
    garbage = struct.pack(">2sBII", b"ML", wire.KIND_REQ, len(bmarker), 0)
    with pytest.raises(ProtocolError) as ei:
        wire.decode_frame(garbage + bmarker)
    assert marker not in str(ei.value)
    bad = b"\xff\xfe" + bmarker
    frame = struct.pack(">2sBII", b"ML", wire.KIND_REQ, len(bad), 0) + bad
    with pytest.raises(ProtocolError) as ei:
        wire.decode_frame(frame)
    assert marker not in str(ei.value) and "0xff" not in str(ei.value)
    hdr = {"rid": marker, "tenant": "t", "age_ms": 0,
           "dtype": marker, "shape": [1]}
    with pytest.raises(ProtocolError) as ei:
        wire.decode_request(hdr, b"\x00")
    assert marker not in str(ei.value)
    for broken in (
        {"rid": None, "tenant": marker},
        {"rid": "r", "tenant": None, "age_ms": marker},
    ):
        with pytest.raises(ProtocolError) as ei:
            wire.decode_request({"dtype": "float32", "shape": [1], **broken},
                                b"\x00" * 4)
        assert marker not in str(ei.value)
    with pytest.raises(ProtocolError) as ei:
        wire.decode_reject({"rid": "r", "code": marker})
    assert marker not in str(ei.value)
    with pytest.raises(ProtocolError) as ei:
        wire.decode_result({"rid": "r", "engine_rid": marker}, b"")
    assert marker not in str(ei.value)
