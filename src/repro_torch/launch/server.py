"""Streaming network front door on PyTorch: the delivery engine behind a
real wire.

Ported from ``repro.launch.server``.  ``DeliveryServer`` serves the typed
delivery API over asyncio TCP with the length-prefixed frame codec
(``repro_torch.runtime.wire``, byte-equal to the reference's frames),
driving an :class:`~repro_torch.runtime.AsyncDeliveryEngine` (background
deadline flusher + per-tenant admission control), whose flusher thread
launches the grouped kernels on the card.  Overload safety is the design center — the
server degrades by *typed rejection*, never by queueing into latency
collapse or silently dropping work:

  * **Load shedding** — a request that would push admitted-but-uncompleted
    rows past ``max_pending_rows`` (or its tenant past the engine's
    admission quota — the front door is constructed ``admission="reject"``)
    is answered with an ``OVERLOADED`` rejection frame immediately.
    Accepted requests keep their deadline-flusher latency; shed requests
    cost one frame round trip.
  * **Deadline propagation** — a request that arrives already past its
    ``deadline_ms`` (client-side age + nothing left to spend) is rejected
    ``EXPIRED`` without touching the engine; otherwise the *remaining*
    budget is what the engine's deadline flusher schedules against.
  * **Slow/stalled clients** — each connection runs its own reader/writer
    tasks with read/write timeouts; a client that stalls mid-frame or stops
    draining responses loses *its* connection (its completed results stay in
    the exactly-once cache for the retry) while the accept loop and every
    other connection keep running.
  * **Exactly-once retries** — requests carry a client-chosen correlation id
    (``rid``); retries and hedges re-send under the same rid.  The server
    tracks in-flight rids (a duplicate attaches as a second waiter, it does
    not resubmit) and caches completed frames (a retry after a lost response
    is answered from cache), so a request is delivered by the engine at most
    once however many times the fleet re-sends it.
  * **Graceful drain** — SIGTERM stops the accept loop, lets the engine
    flush every admitted request, writes all pending responses, notifies
    clients (``BYE``), persists an :class:`EngineSnapshot` when
    ``snapshot_dir`` is configured, and exits 0 with zero lost rids; a
    restarting server restores the snapshot and resumes the same engine id
    space.
  * **Chaos** — a :class:`~repro_torch.runtime.FailureInjector` with network
    phases (``accept``/``read``/``write``/``stall``) makes the server
    misbehave on purpose: dropped fresh connections, requests lost after
    read, truncated response frames, stalled writes.  The client fleet
    (``repro_torch.launch.client``) must still resolve every rid exactly once.

Counters land in ``EngineStats`` (``shed_requests``, ``expired_requests``,
``reconnects``, ``duplicate_hits``), next to a per-tenant security-budget
line computed from ``repro_torch.core.security`` at registration time — the
operator sees the privacy budget of the served tenants beside their latency
budget.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import os
import signal
import sys
import time

import numpy as np

from repro_torch.runtime import api, wire
from repro_torch.runtime.async_engine import (
    AdmissionError, AsyncDeliveryEngine, EngineDeadError,
)
from repro_torch.runtime.wire import ProtocolError

__all__ = ["DeliveryServer", "build_front", "run_serve"]

_log = logging.getLogger(__name__)

# Rejection codes worth caching: deterministic outcomes a retry of the same
# bytes cannot change.  OVERLOADED / DRAINING are transient by definition —
# caching them would turn a momentary shed into a permanent one.
_CACHEABLE_REJECTS = ("EXPIRED", "INVALID", "FAILED")


class _Conn:
    """One client connection: reader/writer stream + outgoing frame queue."""

    __slots__ = ("reader", "writer", "out", "alive", "peer")

    def __init__(self, reader, writer, out_frames: int):
        self.reader = reader
        self.writer = writer
        self.out: asyncio.Queue = asyncio.Queue(maxsize=out_frames)
        self.alive = True
        try:
            self.peer = writer.get_extra_info("peername")
        except Exception:  # pragma: no cover - transport quirk
            self.peer = None


class DeliveryServer:
    """Asyncio TCP front door over an :class:`AsyncDeliveryEngine`.

    Parameters
    ----------
    front:
        The async engine, constructed with ``admission="reject"`` — shedding
        must be a typed response, not submitter backpressure that would
        block the event loop.
    max_pending_rows:
        Global shed threshold: admitted-but-uncompleted rows across all
        tenants.  0 disables the global cap (per-tenant quotas still hold).
    read_timeout / write_timeout:
        Per-connection I/O timeouts (seconds).  A connection that stalls
        mid-frame or stops draining responses is closed; the engine and the
        other connections never wait on it.
    result_cache:
        Completed frames retained for retry deduplication (LRU, per wire
        rid).
    injector:
        Optional :class:`FailureInjector` with ``network_phases`` armed —
        server-side chaos for fleet tests.
    """

    def __init__(
        self,
        front: AsyncDeliveryEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_pending_rows: int = 4096,
        read_timeout: float = 30.0,
        write_timeout: float = 10.0,
        max_frame_bytes: int = wire.DEFAULT_MAX_FRAME,
        result_cache: int = 4096,
        out_frames: int = 256,
        injector=None,
    ):
        if front.admission != "reject":
            raise ValueError(
                "DeliveryServer requires admission='reject': overload must "
                "surface as a typed OVERLOADED frame, not as backpressure "
                "blocking the event loop"
            )
        self.front = front
        self.host = host
        self.port = int(port)
        self.max_pending_rows = int(max_pending_rows)
        self.read_timeout = float(read_timeout)
        self.write_timeout = float(write_timeout)
        self.max_frame_bytes = int(max_frame_bytes)
        self.result_cache = int(result_cache)
        self.out_frames = int(out_frames)
        self.injector = injector

        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._conns: dict[_Conn, asyncio.Task] = {}       # conn -> writer task
        self._inflight: dict[str, set[_Conn]] = {}        # wire rid -> waiters
        self._completed: collections.OrderedDict[str, bytes] = (
            collections.OrderedDict()
        )
        self._draining = False

    # -- stats shorthand ------------------------------------------------------
    @property
    def stats(self):
        return self.front.engine.stats

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def __aenter__(self) -> "DeliveryServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain_and_stop()

    async def drain_and_stop(self, timeout: float = 30.0) -> int:
        """Graceful drain: stop accepting, flush the admitted backlog, write
        every pending response, notify + close connections.  Returns the
        number of wire rids still unresolved at timeout (0 on a clean
        drain)."""
        self._draining = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        deadline = time.monotonic() + timeout
        # Engine side: force the flusher and wait for every admitted request
        # to publish.  front.drain blocks, so it runs off-loop — completion
        # callbacks keep landing on the loop meanwhile.
        self.front.flush_now()
        with contextlib.suppress(TimeoutError, EngineDeadError):
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.front.drain(timeout=timeout)
            )
        # Wire side: _complete callbacks for the drained futures may still be
        # queued on the loop; yield until every in-flight rid resolved.
        while self._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        lost = len(self._inflight)
        # Flush + close every connection: BYE then a sentinel — the writer
        # task drains the queue in order, so all responses hit the socket
        # before the stream ends.
        for conn in list(self._conns):
            if conn.alive:
                self._send(conn, wire.encode_bye("drain"))
            with contextlib.suppress(asyncio.QueueFull):
                conn.out.put_nowait(None)
        if self._conns:
            await asyncio.wait(
                list(self._conns.values()), timeout=self.write_timeout
            )
        for conn in list(self._conns):
            self._close_conn(conn, count_reconnect=False)
        # Durable id space for restart-with-restore.
        if self.front._snapshotter is not None:
            with contextlib.suppress(EngineDeadError):
                await asyncio.get_running_loop().run_in_executor(
                    None, self.front.snapshot_now
                )
        return lost

    # -- connection handling --------------------------------------------------
    async def _on_conn(self, reader, writer) -> None:
        if self._draining or (
            self.injector is not None and self.injector.network_hit("accept")
        ):
            # Drain: no new streams.  Chaos: a connection dropped the moment
            # it is accepted — the client sees a reset and retries.
            if not self._draining:
                self.stats.reconnects += 1
            writer.close()
            return
        conn = _Conn(reader, writer, self.out_frames)
        self._conns[conn] = asyncio.ensure_future(self._writer_loop(conn))
        try:
            while True:
                frame = await asyncio.wait_for(
                    wire.read_frame(reader, self.max_frame_bytes),
                    timeout=self.read_timeout,
                )
                if frame is None:        # clean EOF: client closed
                    break
                kind, header, payload = frame
                if kind == wire.KIND_BYE:
                    break
                if kind != wire.KIND_REQ:
                    raise ProtocolError(
                        f"unexpected frame kind {kind} from a client"
                    )
                self._on_request(conn, header, payload)
        except (asyncio.TimeoutError, ProtocolError, ConnectionError, OSError):
            # Stalled mid-frame, garbage, or a reset: this connection is
            # done — the engine, the accept loop, and every other client
            # are unaffected, and completed results stay cached for the
            # retry on a fresh connection.
            if conn.alive:
                self.stats.reconnects += 1
        finally:
            self._close_conn(conn, count_reconnect=False)

    def _close_conn(self, conn: _Conn, count_reconnect: bool = True) -> None:
        if conn.alive and count_reconnect:
            self.stats.reconnects += 1
        conn.alive = False
        wtask = self._conns.pop(conn, None)
        if wtask is not None and not wtask.done():
            wtask.cancel()
        with contextlib.suppress(Exception):
            conn.writer.close()

    async def _writer_loop(self, conn: _Conn) -> None:
        inj = self.injector
        try:
            while True:
                frame = await conn.out.get()
                if frame is None:
                    with contextlib.suppress(
                        asyncio.TimeoutError, ConnectionError, OSError
                    ):
                        await asyncio.wait_for(
                            conn.writer.drain(), self.write_timeout
                        )
                    break
                if inj is not None and inj.network_hit("stall"):
                    await asyncio.sleep(inj.stall_ms / 1e3)
                if inj is not None and inj.network_hit("write"):
                    # Chaos: truncate the frame mid-write and reset — the
                    # client's reader must fail with a typed ProtocolError
                    # (or EOF) and re-fetch from the result cache.
                    conn.writer.write(frame[: max(1, len(frame) // 2)])
                    raise ConnectionResetError("chaos: truncated write")
                conn.writer.write(frame)
                await asyncio.wait_for(conn.writer.drain(), self.write_timeout)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:  # _close_conn
            raise
        finally:
            if conn.alive:
                conn.alive = False
                self.stats.reconnects += 1
                with contextlib.suppress(Exception):
                    conn.writer.close()

    # -- request path ---------------------------------------------------------
    def _send(self, conn: _Conn, frame: bytes) -> None:
        if not conn.alive:
            return
        try:
            conn.out.put_nowait(frame)
        except asyncio.QueueFull:
            # A client that stopped draining responses: closing it is the
            # bounded-memory answer; its results stay cached for the retry.
            self._close_conn(conn)

    def _finish_now(self, conn: _Conn, rid: str, frame: bytes,
                    code: str | None = None) -> None:
        if code in _CACHEABLE_REJECTS:
            self._remember(rid, frame)
        self._send(conn, frame)

    def _remember(self, rid: str, frame: bytes) -> None:
        self._completed[rid] = frame
        self._completed.move_to_end(rid)
        while len(self._completed) > self.result_cache:
            self._completed.popitem(last=False)

    def _on_request(self, conn: _Conn, header: dict, payload: bytes) -> None:
        stats = self.stats
        rid = header.get("rid")
        if not isinstance(rid, str) or not rid:
            raise ProtocolError(f"request frame without a rid (got {rid!r})")
        if self.injector is not None and self.injector.network_hit("read"):
            # Chaos: the request was read off the socket and then lost
            # before processing — exactly the window a crash-between-read-
            # and-submit opens.  The client's hedge/retry must cover it.
            return
        # Exactly-once: a retry of a completed rid is answered from cache;
        # a retry of an in-flight rid attaches as an extra waiter (hedged
        # duplicate) — neither reaches the engine again.
        cached = self._completed.get(rid)
        if cached is not None:
            stats.duplicate_hits += 1
            self._completed.move_to_end(rid)
            self._send(conn, cached)
            return
        waiters = self._inflight.get(rid)
        if waiters is not None:
            stats.duplicate_hits += 1
            waiters.add(conn)
            return
        try:
            _, age_ms, req = wire.decode_request(header, payload)
        except ProtocolError:
            raise                       # stream-level: close the connection
        except (ValueError, TypeError) as e:
            self._finish_now(
                conn, rid, wire.encode_reject(rid, "INVALID", str(e)),
                code="INVALID",
            )
            return
        if self._draining:
            self._finish_now(
                conn, rid,
                wire.encode_reject(rid, "DRAINING", "server is draining"),
                code="DRAINING",
            )
            return
        # Deadline propagation: the client reports how old the request
        # already is; what is left is the engine's budget.  Nothing left ->
        # EXPIRED without touching the engine.
        if req.deadline_ms is not None:
            remaining = req.deadline_ms - age_ms
            if remaining <= 0:
                stats.expired_requests += 1
                self._finish_now(
                    conn, rid,
                    wire.encode_reject(
                        rid, "EXPIRED",
                        f"deadline_ms={req.deadline_ms:g} already "
                        f"{age_ms:.1f}ms old on arrival",
                    ),
                    code="EXPIRED",
                )
                return
            req = dataclasses.replace(req, deadline_ms=remaining)
        # Load shedding, global cap: reject instead of queueing into
        # latency collapse.  (Per-tenant quotas are the engine's
        # admission="reject" below.)
        # In the front door's unit: images, sequences, or positions for a
        # features request.
        n_rows = api.admission_rows(req) if req.payload.ndim else 1
        if (
            self.max_pending_rows
            and self.front.inflight_rows() + n_rows > self.max_pending_rows
        ):
            stats.shed_requests += 1
            self._finish_now(
                conn, rid,
                wire.encode_reject(
                    rid, "OVERLOADED",
                    f"{self.front.inflight_rows()} rows in flight "
                    f">= max_pending_rows={self.max_pending_rows}",
                ),
            )
            return
        try:
            fut = self.front.submit(req)
        except AdmissionError as e:
            stats.shed_requests += 1
            self._finish_now(
                conn, rid, wire.encode_reject(rid, "OVERLOADED", str(e))
            )
            return
        except (KeyError, ValueError, TypeError) as e:
            self._finish_now(
                conn, rid, wire.encode_reject(rid, "INVALID", str(e)),
                code="INVALID",
            )
            return
        except (EngineDeadError, RuntimeError) as e:
            self._finish_now(
                conn, rid, wire.encode_reject(rid, "FAILED", str(e)),
                code="FAILED",
            )
            return
        self._inflight[rid] = {conn}
        fut.add_done_callback(
            lambda f, rid=rid: self._schedule_complete(rid, f)
        )

    def _schedule_complete(self, rid: str, fut) -> None:
        # Runs on the flusher thread: hop back onto the event loop.  A loop
        # already closed (hard shutdown) simply drops the completion — the
        # result is gone with the process anyway.
        try:
            self._loop.call_soon_threadsafe(self._complete, rid, fut)
        except RuntimeError:  # pragma: no cover - loop torn down
            pass

    def _complete(self, rid: str, fut) -> None:
        waiters = self._inflight.pop(rid, set())
        if fut.cancelled():
            return
        code = None
        exc = fut.exception()
        if exc is None:
            try:
                frame = wire.encode_result(rid, fut.result())
            except ProtocolError as e:  # pragma: no cover - non-wire dtype
                frame, code = wire.encode_reject(rid, "FAILED", str(e)), "FAILED"
        elif isinstance(exc, AdmissionError):
            frame = wire.encode_reject(rid, "OVERLOADED", str(exc))
            self.stats.shed_requests += 1
        else:
            frame, code = wire.encode_reject(rid, "FAILED", str(exc)), "FAILED"
        if code is None and exc is None:
            self._remember(rid, frame)
        elif code in _CACHEABLE_REJECTS:
            self._remember(rid, frame)
        for conn in waiters:
            self._send(conn, frame)


# ---------------------------------------------------------------------------
# The command line (serve.py --mode serve)
# ---------------------------------------------------------------------------

def build_front(args) -> AsyncDeliveryEngine:
    """Build registry + engine + async front door from serve.py flags:
    register ``--tenants`` vision tenants on ``--device``, warm the flush
    path so the first served request doesn't pay the kernels' build and
    the secrets' staging, restore the latest snapshot when
    ``--snapshot-dir`` holds one (same id space across restarts), and fill
    the per-tenant security-budget line."""
    from repro_torch.core import ConvGeometry, SessionRegistry
    from repro_torch.core.security import log2_p_m_bruteforce
    from repro_torch.runtime import (
        DeliveryRequest, EngineStats, FailureInjector, MoLeDeliveryEngine,
    )

    rng = np.random.default_rng(args.seed)
    geom = ConvGeometry(alpha=args.channels, beta=args.out_channels,
                        m=args.image_size, p=3)
    capacity = args.capacity if args.capacity is not None else args.tenants
    registry = SessionRegistry(geom, kappa=args.kappa, capacity=capacity)
    fan_in = geom.alpha * geom.p * geom.p
    from repro_torch.launch.serve import _weights_of

    weights = _weights_of(args, args.tenants)
    for i in range(args.tenants):
        kernels = rng.standard_normal(
            (geom.alpha, geom.beta, geom.p, geom.p)
        ).astype(np.float32) / np.sqrt(fan_in)
        registry.register(f"tenant-{i}", kernels, weight=weights[i])

    engine = MoLeDeliveryEngine(registry, device=args.device)
    # Warm the flush path the fleet's steady state will hit (kernel build
    # and load, the secret stacks' staging), so served latency is the
    # flush.
    warm = [
        engine.submit(DeliveryRequest(
            f"tenant-{i}",
            np.zeros((args.warm_batch, geom.alpha, geom.m, geom.m), np.float32),
        ))
        for i in range(args.tenants)
    ]
    engine.flush()
    for rid in warm:
        engine.take(rid)
    engine.stats = EngineStats()
    engine.stats.service_share_fn = engine.scheduler.service_share

    injector = None
    if args.inject_failure or args.chaos:
        injector = FailureInjector(
            at_phases={args.inject_failure} if args.inject_failure else set(),
            network_phases=(
                {"accept", "read", "write", "stall"} if args.chaos else set()
            ),
            network_rate=args.chaos_rate,
            stall_ms=min(200.0, args.read_timeout_ms / 4),
            seed=args.chaos_seed,
        )
    front = AsyncDeliveryEngine(
        engine,
        max_delay_ms=args.max_delay_ms,
        max_inflight_rows=args.max_inflight_rows,
        admission="reject",
        snapshot_dir=args.snapshot_dir,
        prefetch_horizon_ms=args.prefetch_horizon_ms,
        injector=injector if args.inject_failure else None,
    )
    front.server_injector = injector
    if args.snapshot_dir is not None:
        try:
            replayed = front.restore()
        except FileNotFoundError:
            pass                               # first boot: nothing to restore
        else:
            # Replayed in-flight requests have no wire waiters (their
            # clients will retry under fresh engine rids); what matters is
            # the id space resumed — report and let the flusher deliver
            # them into the futures we drop.
            print(f"restored snapshot: {len(replayed)} in-flight rids "
                  f"replayed, id space resumed", flush=True)
    # Security budget on the served path: the brute-force attack-success
    # bound for each tenant's morphing secrets (paper §4.2), so --stats
    # reports privacy next to latency.
    for t in registry.tenant_ids:
        engine.stats.security_budget_log2[t] = log2_p_m_bruteforce(
            sigma=0.5, alpha=geom.alpha, m=geom.m, kappa=args.kappa
        )
    return front


def run_serve(args) -> dict:
    """serve.py ``--mode serve``: build the front door, serve until
    SIGTERM/SIGINT, drain gracefully, exit 0 with zero lost rids.

    Installs the signal handlers, so it runs in the main thread only; an
    in-process server (tests, ``chip_smoke.py``) drives
    :class:`DeliveryServer` directly."""
    front = build_front(args)
    server = DeliveryServer(
        front,
        host=args.host, port=args.port,
        max_pending_rows=args.max_pending_rows,
        read_timeout=args.read_timeout_ms / 1e3,
        write_timeout=args.write_timeout_ms / 1e3,
        injector=front.server_injector,
    )

    async def _amain() -> int:
        await server.start()
        print(f"serving on {server.host}:{server.port} pid={os.getpid()}",
              flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        print("drain: SIGTERM/SIGINT received, stopping accepts", flush=True)
        return await server.drain_and_stop(timeout=args.drain_timeout_ms / 1e3)

    lost = asyncio.run(_amain())
    stats = front.engine.stats
    with contextlib.suppress(EngineDeadError, TimeoutError):
        front.close()
    if args.stats:
        print("engine stats:")
        for line in stats.summary().splitlines():
            print(f"  {line}")
    print(f"drained: lost_rids={lost} shed={stats.shed_requests} "
          f"expired={stats.expired_requests} reconnects={stats.reconnects} "
          f"duplicate_hits={stats.duplicate_hits}", flush=True)
    if lost:
        sys.exit(1)
    return {"lost_rids": lost, "shed": stats.shed_requests}
