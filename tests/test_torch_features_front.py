"""The continuous LM ``features`` lane through the port's front doors on the
CPU: the async front door (``runtime.async_engine``; concurrent submitters,
an injected crash, a snapshot restored into a fresh front door) and the TCP
front door (``launch.server`` driven by ``launch.client``'s fleet).

Every request id resolves once, and every delivered array equals what the
sync engine delivers for the same request within 1e-5 x max (the two may
coalesce the rows into other microbatch shapes, which sums in another
order).  The server's global row cap counts a features request's
positions, the async front door's admission unit.
"""
import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lm import LMSessionRegistry  # noqa: E402
from repro_torch.launch.client import ClientFleet, FleetConfig  # noqa: E402
from repro_torch.launch.server import DeliveryServer  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AsyncDeliveryEngine, DeliveryRequest, FailureInjector, MoLeDeliveryEngine,
    wire,
)

VOCAB, D, D_IN, D_OUT, KAPPA = 32, 8, 12, 10, 2
SMALL = dict(max_rows=8, row_buckets=(1, 2, 4, 8), group_buckets=(1, 2, 4))
REL = 1e-5


def _registry(tenants=3):
    rng = np.random.default_rng(7)
    reg = LMSessionRegistry(VOCAB, D, d_in=D_IN, d_out=D_OUT, kappa=KAPPA)
    for i in range(tenants):
        reg.register(
            f"tenant-{i}", rng.standard_normal((VOCAB, D)).astype(np.float32),
            w_in=(rng.standard_normal((D_IN, D_OUT)) / np.sqrt(D_IN)).astype(
                np.float32),
            seed=60 + i)
    return reg


def _requests(rng, n, tenants=3):
    """Rank-3 and rank-2 features requests, round-robin over tenants."""
    shapes = [(1, 5, D_IN), (3, D_IN), (2, 3, D_IN)]
    return [DeliveryRequest(f"tenant-{i % tenants}",
                            rng.standard_normal(shapes[i % 3]).astype(
                                np.float32),
                            lane="features")
            for i in range(n)]


def _hold_sync(reg, pairs):
    """Each (request, delivered) against the sync engine's delivery of the
    same request, at 1e-5 x max."""
    sync = MoLeDeliveryEngine(lm_registry=reg, device="cpu", **SMALL)
    for req, got in pairs:
        want = sync.deliver(req).payload
        assert got.shape == want.shape == req.payload.shape[:-1] + (D_OUT,)
        err = float(np.abs(got - want).max())
        assert err <= REL * float(np.abs(want).max()), err


def _front(reg, **kw):
    return AsyncDeliveryEngine(
        MoLeDeliveryEngine(lm_registry=reg, device="cpu", **SMALL),
        max_delay_ms=5.0, **kw)


def test_async_front_door_delivers_features_once(rng):
    """Four submitter threads, 24 features requests: 24 distinct rids, each
    the sync engine's result for its request."""
    reg = _registry()
    reqs = _requests(rng, 24)
    futs = [None] * len(reqs)
    with _front(reg) as front:
        def worker(w):
            for i in range(w, len(reqs), 4):
                futs[i] = front.submit(reqs[i])

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        results = [f.result(timeout=60) for f in futs]
        assert front.pending() == 0
        stats = front.engine.stats
    assert len({r.request_id for r in results}) == len(reqs)
    assert all(r.lane == "features" for r in results)
    assert stats.rows_in == sum(
        int(np.prod(q.payload.shape[:-1])) for q in reqs)
    _hold_sync(reg, [(q, r.payload) for q, r in zip(reqs, results)])


def test_async_features_survive_injected_crash_and_restore(rng):
    """A device-phase crash: the supervisor replays the round, each rid
    resolves once with the sync engine's result.  A backlog snapshotted
    from a sync engine restores into a fresh front door over a fresh
    registry and resolves each replayed rid once, likewise."""
    reg = _registry()
    reqs = _requests(rng, 9)
    with _front(reg, injector=FailureInjector(at_phases={"device"})) as front:
        results = [f.result(timeout=60)
                   for f in [front.submit(q) for q in reqs]]
        assert front._restarts == 1
        assert front.engine.injector.fired == {"device"}
    assert len({r.request_id for r in results}) == len(reqs)
    _hold_sync(reg, [(q, r.payload) for q, r in zip(reqs, results)])

    writer = MoLeDeliveryEngine(lm_registry=reg, device="cpu", **SMALL)
    backlog = _requests(rng, 5)
    rids = [writer.submit(q) for q in backlog]
    fresh_reg = LMSessionRegistry(VOCAB, D, d_in=D_IN, d_out=D_OUT,
                                  kappa=KAPPA)
    with _front(fresh_reg) as fresh:
        futs = fresh.restore(writer.snapshot())
        assert sorted(futs) == rids
        restored = [futs[r].result(timeout=60) for r in rids]
    assert [r.request_id for r in restored] == rids
    _hold_sync(reg, [(q, r.payload) for q, r in zip(backlog, restored)])


def _run_served(front, body, **server_kw):
    async def go():
        server = DeliveryServer(front, host="127.0.0.1", port=0, **server_kw)
        await server.start()
        try:
            return await body(server)
        finally:
            await server.drain_and_stop(timeout=30.0)

    return asyncio.run(go())


def test_tcp_fleet_delivers_features_once():
    """The client fleet sends 12 (1, 5, d_in) features requests over
    loopback to the TCP front door: every rid ok exactly once, each payload
    the sync engine's result for the fleet's own request."""
    reg = _registry()
    front = _front(reg, admission="reject")

    async def body(server):
        return await ClientFleet(FleetConfig(
            port=server.port, requests=12, clients=3, tenants=3, batch=1,
            features=(5, D_IN), trace="burst:12@1", keep_payloads=True,
        )).run()

    try:
        report = _run_served(front, body)
    finally:
        front.close()
    report.assert_exactly_once()
    assert report.counts() == {"ok": 12}
    assert len(set(report.engine_rids.values())) == 12
    assert all(q.lane == "features" for q in report.requests.values())
    _hold_sync(reg, [(report.requests[rid], report.payloads[rid])
                     for rid in sorted(report.requests)])


def test_server_row_cap_counts_feature_positions(rng):
    """``max_pending_rows`` is in the front door's unit, positions for a
    features request: one request of 12 positions is shed OVERLOADED at a
    cap of 8, one of 4 positions is served."""
    front = _front(_registry(), admission="reject")
    frames = [
        wire.encode_request(DeliveryRequest(
            "tenant-0", rng.standard_normal((1, n, D_IN)).astype(np.float32),
            lane="features"), f"r-{n}")
        for n in (12, 4)
    ]

    async def body(server):
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                      server.port)
        out = []
        for frame in frames:
            writer.write(frame)
            await writer.drain()
            out.append(await asyncio.wait_for(wire.read_frame(reader),
                                              timeout=30))
        writer.close()
        return out

    try:
        (k1, h1, _), (k2, h2, b2) = _run_served(front, body,
                                                max_pending_rows=8)
    finally:
        front.close()
    assert k1 == wire.KIND_REJ and h1["code"] == "OVERLOADED"
    assert k2 == wire.KIND_RES
    assert wire.decode_result(h2, b2).payload.shape == (1, 4, D_OUT)
    assert front.engine.stats.shed_requests == 1


def test_server_rejects_empty_feature_rows_invalid(rng):
    """A features frame of shape (2, 0) is answered with an INVALID REJ on
    the same connection, which then goes on serving a good request."""
    front = _front(_registry(), admission="reject")
    frames = [
        wire.encode_request(DeliveryRequest(
            "tenant-0", np.zeros((2, 0), np.float32), lane="features"), "bad"),
        wire.encode_request(DeliveryRequest(
            "tenant-0", rng.standard_normal((3, D_IN)).astype(np.float32),
            lane="features"), "good"),
    ]

    async def body(server):
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                      server.port)
        out = []
        for frame in frames:
            writer.write(frame)
            await writer.drain()
            out.append(await asyncio.wait_for(wire.read_frame(reader),
                                              timeout=30))
        writer.close()
        return out

    try:
        (k1, h1, _), (k2, h2, b2) = _run_served(front, body,
                                                max_pending_rows=8)
    finally:
        front.close()
    assert k1 == wire.KIND_REJ and h1["code"] == "INVALID"
    assert h1["rid"] == "bad"
    assert k2 == wire.KIND_RES
    assert wire.decode_result(h2, b2).payload.shape == (3, D_OUT)
