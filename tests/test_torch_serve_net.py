"""The port's network front door (``repro_torch.launch.server``) and client
fleet (``repro_torch.launch.client``) over loopback sockets, in process, on
the CPU.

Held as ``tests/test_serve_net.py`` holds the reference's: served results
equal per-request delivery, every fleet rid resolves exactly once, overload
sheds with typed OVERLOADED frames (the global cap and the per-tenant
quota), expired deadlines and unknown tenants get typed rejections,
duplicate rids are answered from the completed-frame cache, garbage closes
one connection and not the server, a drain rejects new requests typed, and
chaos at both ends plus an injected flusher crash still resolves every rid
once.  Across packages: the reference's client fleet against the port's
server, and the port's fleet against the reference's server, in one
process.  Server processes (``serve --mode serve``, ``client
--spawn-server``) are tested in ``tests/test_torch_serve_process.py``.
"""
import argparse
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.runtime as jrt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.launch import client as jclient  # noqa: E402
from repro.launch.server import DeliveryServer as JServer  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.client import ClientFleet, FleetConfig, run_fleet  # noqa: E402
from repro_torch.launch.server import DeliveryServer, build_front  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AsyncDeliveryEngine, DeliveryRequest, FailureInjector, MoLeDeliveryEngine,
)
from repro_torch.runtime import wire  # noqa: E402

SHAPE = (2, 4, 6, 3)            # alpha, beta, m, p
GEOM = tcore.ConvGeometry(*SHAPE)
ATOL = 1e-5


def _registries(tenants=3, kappa=2):
    rng = np.random.default_rng(3)
    jg = jcore.ConvGeometry(*SHAPE)
    jreg = jcore.SessionRegistry(jg, kappa=kappa, capacity=tenants)
    for i in range(tenants):
        k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(
            np.float32) / 4
        jreg.register(f"tenant-{i}", k, seed=30 + i)
    treg = tcore.SessionRegistry(GEOM, kappa=kappa, capacity=tenants)
    treg.restore_state(*jreg.snapshot_state())
    return jreg, treg


def _front(tenants=3, injector=None, **kw):
    _, reg = _registries(tenants)
    kw.setdefault("max_delay_ms", 5.0)
    return AsyncDeliveryEngine(MoLeDeliveryEngine(reg, "cpu"),
                               admission="reject", injector=injector, **kw)


def _run_served(front, body, server_cls=DeliveryServer, **server_kw):
    """Start a server on an ephemeral loopback port, run ``body(server)``
    inside the loop, then drain."""
    async def go():
        server = server_cls(front, host="127.0.0.1", port=0, **server_kw)
        await server.start()
        try:
            return await body(server)
        finally:
            await server.drain_and_stop(timeout=30.0)

    return asyncio.run(go())


def _fleet_cfg(port, cfg_cls=FleetConfig, **kw):
    kw.setdefault("requests", 9)
    kw.setdefault("clients", 3)
    kw.setdefault("tenants", 3)
    kw.setdefault("batch", 2)
    kw.setdefault("channels", GEOM.alpha)
    kw.setdefault("image_size", GEOM.m)
    kw.setdefault("trace", "uniform:500")
    return cfg_cls(port=port, **kw)


async def _one_request(port, frames, connected=lambda: None):
    """Send ``frames`` on one connection; read one frame back per frame.
    ``connected`` runs once the connection is open."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    connected()
    out = []
    for frame in frames:
        writer.write(frame)
        await writer.drain()
        out.append(await asyncio.wait_for(wire.read_frame(reader), timeout=30))
    writer.close()
    return out


def _want(front, tenant, payload):
    return front.registry.session(tenant).deliver(
        torch.from_numpy(payload)).numpy()


# ---------------------------------------------------------------------------
# correctness and exactly-once
# ---------------------------------------------------------------------------

def test_server_requires_reject_admission():
    front = _front()
    blocking = AsyncDeliveryEngine(front.engine, admission="block")
    with pytest.raises(ValueError, match="admission"):
        DeliveryServer(blocking)
    blocking.close()
    front.close()


def test_served_results_match_direct_sessions(rng):
    front = _front()
    payload = rng.standard_normal((2, GEOM.alpha, GEOM.m, GEOM.m)).astype(
        np.float32)
    frame = wire.encode_request(DeliveryRequest("tenant-1", payload), "d-1")
    [(kind, header, body)] = _run_served(
        front, lambda s: _one_request(s.port, [frame]))
    assert kind == wire.KIND_RES
    res = wire.decode_result(header, body)
    np.testing.assert_allclose(res.payload, _want(front, "tenant-1", payload),
                               rtol=1e-5, atol=ATOL)
    front.close()


def test_fleet_all_resolved_exactly_once():
    front = _front()

    async def body(server):
        return await ClientFleet(_fleet_cfg(server.port)).run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 9}
    assert len(report.latencies_ms) == 9
    assert len(set(report.engine_rids.values())) == 9
    front.close()


def test_reference_fleet_against_the_port_server():
    """The reference's client fleet, over loopback, against the port's
    server: every rid exactly once, each payload per-request delivery's for
    the fleet's own (seeded) request."""
    front = _front()

    async def body(server):
        cfg = _fleet_cfg(server.port, cfg_cls=jclient.FleetConfig, seed=4)
        fleet = jclient.ClientFleet(cfg)
        made = {}
        make = fleet._make_request
        fleet._make_request = lambda i: made.setdefault(i, make(i))
        payloads = {}
        on_result = fleet._on_result

        def record(res):
            payloads.setdefault(res.rid, res.payload)
            on_result(res)

        fleet._on_result = record
        return await fleet.run(), made, payloads

    report, made, payloads = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 9}
    for i, req in made.items():
        np.testing.assert_allclose(payloads[f"f0-{i}"],
                                   _want(front, req.tenant_id, req.payload),
                                   atol=ATOL)
    front.close()


def test_port_fleet_against_the_reference_server():
    jreg, _ = _registries()
    jfront = jrt.AsyncDeliveryEngine(
        jrt.MoLeDeliveryEngine(jreg, backend="jnp"), max_delay_ms=5.0,
        admission="reject")

    async def body(server):
        return await ClientFleet(_fleet_cfg(server.port)).run()

    report = _run_served(jfront, body, server_cls=JServer)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 9}
    jfront.close()


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "default"])
def test_fleet_keeps_requests_and_first_payloads(keep):
    """With ``keep_payloads`` the report holds each rid's request and its
    first delivered payload (per-request delivery's for that request);
    without it, neither."""
    front = _front()

    async def body(server):
        cfg = _fleet_cfg(server.port, keep_payloads=keep, seed=5)
        return await ClientFleet(cfg).run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 9}
    if not keep:
        assert report.requests == {} and report.payloads == {}
    else:
        assert sorted(report.requests) == sorted(report.payloads) == sorted(
            report.outcomes)
        for rid, req in report.requests.items():
            np.testing.assert_allclose(report.payloads[rid],
                                       _want(front, req.tenant_id, req.payload),
                                       atol=ATOL)
    front.close()


# ---------------------------------------------------------------------------
# load shedding, deadlines, typed rejections
# ---------------------------------------------------------------------------

def test_overload_sheds_with_typed_rejections():
    front = _front(max_inflight_rows=4096)

    async def body(server):
        cfg = _fleet_cfg(server.port, requests=24, batch=4,
                         trace="burst:24@1", max_attempts=1)
        return await ClientFleet(cfg).run()

    report = _run_served(front, body, max_pending_rows=8)
    report.assert_exactly_once()
    counts = report.counts()
    assert counts.get("rejected:OVERLOADED", 0) > 0 and counts.get("ok", 0) > 0
    assert counts["rejected:OVERLOADED"] + counts["ok"] == 24
    assert front.engine.stats.shed_requests == counts["rejected:OVERLOADED"]
    front.close()


def test_per_tenant_quota_sheds_overloaded():
    front = _front(max_inflight_rows=2)

    async def body(server):
        cfg = _fleet_cfg(server.port, requests=12, batch=2, tenants=1,
                         trace="burst:12@1", max_attempts=1)
        return await ClientFleet(cfg).run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts().get("rejected:OVERLOADED", 0) > 0
    assert front.engine.stats.rejected > 0
    front.close()


@pytest.mark.parametrize("case", ["expired", "invalid_tenant", "draining"])
def test_typed_rejections(case):
    """Expired on arrival (age >= deadline), an unknown tenant, and a
    request on a draining server: one typed rejection each, the engine
    untouched."""
    front = _front()
    tenant = "no-such-tenant" if case == "invalid_tenant" else "tenant-0"
    req = DeliveryRequest(
        tenant, np.zeros((1, GEOM.alpha, GEOM.m, GEOM.m), np.float32),
        deadline_ms=50.0 if case == "expired" else None,
    )
    frame = wire.encode_request(req, "r-1",
                                age_ms=80.0 if case == "expired" else 0.0)

    def connected():
        # A drain begun after the connection opened (a new connection on a
        # draining server is closed unread).
        server_box[0]._draining = case == "draining"

    server_box = []

    async def body(server):
        server_box.append(server)
        return await _one_request(server.port, [frame], connected)

    [(kind, header, _)] = _run_served(front, body)
    assert kind == wire.KIND_REJ
    code = wire.decode_reject(header).code
    assert code == {"expired": "EXPIRED", "invalid_tenant": "INVALID",
                    "draining": "DRAINING"}[case]
    assert front.engine.stats.expired_requests == (case == "expired")
    assert front.engine.stats.requests == 0
    front.close()


def test_unknown_tenant_fleet_rejected_invalid():
    front = _front()

    async def body(server):
        cfg = _fleet_cfg(server.port, requests=3, tenants=1, max_attempts=1,
                         fleet_id="bad")
        fleet = ClientFleet(cfg)
        fleet._make_request = lambda idx: DeliveryRequest(
            "no-such-tenant",
            np.zeros((1, GEOM.alpha, GEOM.m, GEOM.m), np.float32))
        return await fleet.run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"rejected:INVALID": 3}
    front.close()


def test_duplicate_rid_served_from_cache():
    front = _front()
    req = DeliveryRequest(
        "tenant-2", np.ones((1, GEOM.alpha, GEOM.m, GEOM.m), np.float32))
    frame = wire.encode_request(req, "dup-1")
    (k1, h1, p1), (k2, h2, p2) = _run_served(
        front, lambda s: _one_request(s.port, [frame, frame]))
    assert k1 == k2 == wire.KIND_RES
    r1, r2 = wire.decode_result(h1, p1), wire.decode_result(h2, p2)
    assert r1.engine_rid == r2.engine_rid          # one engine delivery
    np.testing.assert_array_equal(r1.payload, r2.payload)
    assert front.engine.stats.duplicate_hits == 1
    assert front.engine.stats.requests == 1
    front.close()


def test_garbage_frame_closes_connection_not_server():
    front = _front()

    async def body(server):
        r1, w1 = await asyncio.open_connection("127.0.0.1", server.port)
        w1.write(b"this is not a delivery frame at all.....")
        await w1.drain()
        assert await asyncio.wait_for(r1.read(), timeout=30) == b""
        w1.close()
        return await ClientFleet(_fleet_cfg(server.port, requests=3)).run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 3}
    assert front.engine.stats.reconnects >= 1
    front.close()


def test_exactly_once_under_chaos_with_flusher_crash():
    """Server-side network chaos (dropped accepts, lost reads, truncated and
    stalled writes), client-side chaos (truncated requests, dropped
    connections) and one injected flusher crash: every rid resolves exactly
    once, with no mismatched duplicate payloads."""
    inj = FailureInjector(
        at_phases={"device"},
        network_phases={"accept", "read", "write", "stall"},
        network_rate=0.12, stall_ms=50.0, seed=5,
    )
    front = _front(injector=inj)

    async def body(server):
        client_inj = FailureInjector(
            network_phases={"write", "read", "stall"},
            network_rate=0.12, stall_ms=50.0, seed=6,
        )
        cfg = _fleet_cfg(server.port, requests=18, clients=4,
                         trace="uniform:300", chaos=client_inj,
                         attempt_timeout_ms=1000.0, timeout_ms=45000.0,
                         max_attempts=8)
        return await ClientFleet(cfg).run()

    report = _run_served(front, body, injector=inj, read_timeout=3.0)
    report.assert_exactly_once()
    counts = report.counts()
    assert sum(counts.values()) == 18
    assert counts.get("ok", 0) >= 12
    assert report.mismatched_dups == 0
    assert report.hedges + report.retries + report.conn_drops > 0
    assert "device" in inj.fired
    front.close()


def test_fleet_report_flags_lost_and_mismatched_rids():
    from repro_torch.launch.client import FleetReport

    report = FleetReport(submitted=2, outcomes={"a": "ok"})
    with pytest.raises(AssertionError, match="silently lost"):
        report.assert_exactly_once()
    report = FleetReport(submitted=1, outcomes={"a": "ok"}, mismatched_dups=1)
    with pytest.raises(AssertionError, match="different results"):
        report.assert_exactly_once()
    assert set(FleetReport().as_dict()) >= {"submitted", "counts", "p50_ms"}


# ---------------------------------------------------------------------------
# the serve --mode serve front door, built in process
# ---------------------------------------------------------------------------

def _serve_args(**kw) -> argparse.Namespace:
    argv = ["--mode", "serve", "--device", "cpu", "--tenants", "3",
            "--kappa", "2", "--channels", str(GEOM.alpha),
            "--out-channels", str(GEOM.beta), "--image-size", str(GEOM.m),
            "--warm-batch", "2"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return tserve.parse_args(argv)


def test_build_front_serves_and_restores_its_snapshot(tmp_path):
    """``build_front`` registers the tenants, warms the flush path, fills
    the security budget, and a second build over the same snapshot
    directory resumes the id space of the first."""
    args = _serve_args(snapshot_dir=tmp_path / "snap")
    front = build_front(args)
    assert front.admission == "reject" and front.engine.device.type == "cpu"
    assert set(front.stats.security_budget_log2) == {
        "tenant-0", "tenant-1", "tenant-2"}
    assert front.stats.requests == 0               # warm-up stats reset

    async def body(server):
        return await ClientFleet(_fleet_cfg(server.port, requests=6)).run()

    report = _run_served(front, body)
    report.assert_exactly_once()
    assert report.counts() == {"ok": 6}
    front.close()
    again = build_front(args)
    report2 = _run_served(again, lambda s: ClientFleet(
        _fleet_cfg(s.port, requests=3, fleet_id="f1")).run())
    report2.assert_exactly_once()
    assert min(report2.engine_rids.values()) > max(report.engine_rids.values())
    again.close()


def test_run_fleet_is_the_fleet():
    front = _front()
    report = _run_served(front, lambda s: run_fleet(
        _fleet_cfg(s.port, requests=3)))
    assert report.counts() == {"ok": 3}
    front.close()
