"""Load-generating client fleet for the network front door.

Ported from ``repro.launch.client`` (numpy, asyncio and the port's wire
codec; no torch).  ``ClientFleet`` drives a ``serve.py --mode serve``
server (``repro_torch.launch.server``, or the reference's: the frames are
the same bytes) the way a misbehaving production client
population would, and *proves the delivery guarantee from the outside*:
every submitted wire rid resolves **exactly once** — a result, a typed
rejection, or a client-side timeout — never silently lost, never resolved
twice with different outcomes.

Mechanics:

  * **Open-loop arrivals** — requests launch on a schedule (``uniform:<rps>``,
    ``poisson:<rps>``, or ``burst:<n>@<gap_ms>``) independent of completions,
    so an overloaded server sees true queue growth, not closed-loop
    self-throttling.
  * **Retries + hedging, exactly-once keyed** — every request carries a
    fleet-chosen correlation ``rid``; a connection error retries it under
    capped exponential backoff with jitter, a response slower than
    ``attempt_timeout_ms`` *hedges* it (re-sends the same rid on another
    connection).  The server deduplicates on rid, so retries can never
    double-deliver; the fleet guards the other side (a second terminal frame
    for an already-resolved rid is counted, checked for payload agreement,
    and dropped).
  * **Typed rejection handling** — ``OVERLOADED``/``EXPIRED``/``INVALID``/
    ``FAILED`` are terminal outcomes; codes in ``retry_codes`` (e.g.
    ``DRAINING`` when riding across a server restart) trigger
    backoff-and-retry instead.
  * **Client-side chaos** — with a :class:`FailureInjector`, the fleet
    truncates request frames mid-write, stalls mid-frame (exercising the
    server's read timeout), and drops connections right after sending
    (losing the response — the retry must be answered from the server's
    result cache).

``main()`` adds ``--spawn-server`` (launch ``python -m
repro_torch.launch.serve --mode serve`` as a subprocess on ``--device``,
parse its ephemeral port, SIGTERM it afterwards and require a clean
graceful-drain exit) and ``--report`` (JSON artifact with outcome counts
and latency quantiles).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from repro_torch.runtime import wire
from repro_torch.runtime.api import DeliveryRequest
from repro_torch.runtime.resilience import FailureInjector

__all__ = ["FleetConfig", "FleetReport", "ClientFleet", "run_fleet",
           "spawn_server", "stop_server", "main"]


@dataclasses.dataclass
class FleetConfig:
    host: str = "127.0.0.1"
    port: int = 0
    requests: int = 32
    clients: int = 4                  # concurrent connections
    tenants: int = 4
    batch: int = 8                    # rows per request
    channels: int = 3
    image_size: int = 16
    # (positions, d_in): each request is (batch, positions, d_in) features
    # on the LM "features" lane instead of images on the vision lane.
    features: tuple[int, int] | None = None
    trace: str = "uniform:200"        # uniform:<rps> | poisson:<rps> | burst:<n>@<gap_ms>
    timeout_ms: float = 20000.0       # total per-rid budget -> "timeout" outcome
    attempt_timeout_ms: float = 2000.0  # hedge trigger: re-send after this
    max_attempts: int = 6
    backoff_base_ms: float = 50.0
    backoff_cap_ms: float = 1000.0
    deadline_ms: float | None = None
    priority: int = 0
    seed: int = 0
    fleet_id: str = "f0"
    retry_codes: frozenset = frozenset()   # rejection codes to retry, e.g. {"DRAINING"}
    chaos: FailureInjector | None = None
    max_frame_bytes: int = wire.DEFAULT_MAX_FRAME
    keep_payloads: bool = False       # report each request and its first payload


@dataclasses.dataclass
class FleetReport:
    """Client-observed outcome of one fleet run.  ``outcomes`` maps every
    submitted rid to exactly one of ``"ok"``, ``"rejected:<CODE>"``, or
    ``"timeout"`` — :meth:`assert_exactly_once` is the delivery guarantee
    checked from outside the process."""

    submitted: int = 0
    outcomes: dict = dataclasses.field(default_factory=dict)
    latencies_ms: list = dataclasses.field(default_factory=list)  # ok only
    engine_rids: dict = dataclasses.field(default_factory=dict)   # rid -> engine rid
    retries: int = 0          # re-sends after a connection-level failure
    hedges: int = 0           # re-sends after a response timeout
    conn_drops: int = 0       # connections lost (chaos, resets, timeouts)
    dup_responses: int = 0    # frames for an already-resolved rid (dropped)
    mismatched_dups: int = 0  # ... whose payload disagreed (must stay 0)
    close_errors: dict = dataclasses.field(default_factory=dict)
    # ^ error class -> count from connection teardown; teardown failures
    #   are expected under chaos but never silently swallowed.
    # Filled only with FleetConfig.keep_payloads, so a caller can hold each
    # delivered array against its own request:
    requests: dict = dataclasses.field(default_factory=dict)  # rid -> DeliveryRequest
    payloads: dict = dataclasses.field(default_factory=dict)  # rid -> first ok payload

    def record_close_error(self, e: BaseException) -> None:
        cls = type(e).__name__
        self.close_errors[cls] = self.close_errors.get(cls, 0) + 1

    def counts(self) -> dict:
        out: dict[str, int] = {}
        for kind in self.outcomes.values():
            out[kind] = out.get(kind, 0) + 1
        return out

    def quantile_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.quantile(np.asarray(self.latencies_ms), q))

    def assert_exactly_once(self) -> None:
        missing = self.submitted - len(self.outcomes)
        if missing:
            raise AssertionError(
                f"{missing} of {self.submitted} rids never resolved — "
                f"requests were silently lost"
            )
        if self.mismatched_dups:
            raise AssertionError(
                f"{self.mismatched_dups} duplicate responses disagreed with "
                f"the first-resolved outcome — a rid was delivered twice "
                f"with different results"
            )

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "counts": self.counts(),
            "p50_ms": self.quantile_ms(0.50),
            "p95_ms": self.quantile_ms(0.95),
            "p99_ms": self.quantile_ms(0.99),
            "retries": self.retries,
            "hedges": self.hedges,
            "conn_drops": self.conn_drops,
            "dup_responses": self.dup_responses,
            "mismatched_dups": self.mismatched_dups,
            "close_errors": dict(self.close_errors),
        }


class _Pending:
    __slots__ = ("ev", "outcome", "latency_ms", "engine_rid", "digest",
                 "nacked", "t0")

    def __init__(self):
        self.ev = asyncio.Event()
        self.outcome: str | None = None
        self.latency_ms: float | None = None
        self.engine_rid: int | None = None
        self.digest: str | None = None
        self.nacked = False            # retryable rejection: retry, not resolve
        self.t0 = 0.0


class _Chan:
    """One pooled connection: serialized writes + a background reader that
    dispatches response frames to the fleet's pending table.  Connections
    are lazy and self-healing — any error clears the streams and the next
    ``send`` reconnects."""

    def __init__(self, fleet: "ClientFleet", cid: int):
        self.fleet = fleet
        self.cid = cid
        self.reader = None
        self.writer = None
        self._rtask: asyncio.Task | None = None
        self._lock = asyncio.Lock()

    async def _connect(self) -> None:
        cfg = self.fleet.cfg
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(cfg.host, cfg.port), timeout=5.0
        )
        self._rtask = asyncio.ensure_future(self._read_loop(self.reader))

    def _drop(self) -> None:
        if self.writer is not None:
            self.fleet.report.conn_drops += 1
            try:
                self.writer.close()
            except Exception as e:
                # Teardown of an already-broken transport is non-fatal,
                # but the error class lands on the report instead of
                # vanishing — assert_exactly_once stays the real gate.
                self.fleet.report.record_close_error(e)
        self.reader = self.writer = None

    async def send(self, frame: bytes) -> bool:
        """Write one frame; False means connection-level failure (caller
        backs off and retries).  Chaos may corrupt the write while still
        returning True — the client *believes* it sent, exactly the
        ambiguity the rid-keyed retry protocol exists for."""
        inj = self.fleet.cfg.chaos
        async with self._lock:
            try:
                if self.writer is None:
                    await self._connect()
                if inj is not None and inj.network_hit("stall"):
                    # Stall mid-frame: send the head, hold the body longer
                    # than the server's read timeout would like.
                    self.writer.write(frame[:4])
                    await self.writer.drain()
                    await asyncio.sleep(inj.stall_ms / 1e3)
                    frame = frame[4:]
                if inj is not None and inj.network_hit("write"):
                    # Truncate the request mid-write and drop the conn: the
                    # server must ProtocolError this stream, not wedge on it.
                    self.writer.write(frame[: max(1, len(frame) // 2)])
                    await self.writer.drain()
                    self._drop()
                    return True
                self.writer.write(frame)
                await self.writer.drain()
                if inj is not None and inj.network_hit("read"):
                    # Sent fine, then lose the conn: the response is gone —
                    # the retry must be served from the result cache.
                    self._drop()
                return True
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self._drop()
                return False

    async def _read_loop(self, reader) -> None:
        cfg = self.fleet.cfg
        try:
            while True:
                frame = await wire.read_frame(reader, cfg.max_frame_bytes)
                if frame is None:
                    break
                kind, header, payload = frame
                if kind == wire.KIND_RES:
                    res = wire.decode_result(header, payload)
                    self.fleet._on_result(res)
                elif kind == wire.KIND_REJ:
                    rej = wire.decode_reject(header)
                    self.fleet._on_reject(rej)
                elif kind == wire.KIND_BYE:
                    break
                else:
                    raise wire.ProtocolError(
                        f"unexpected frame kind {kind} from server"
                    )
        except (wire.ProtocolError, ConnectionError, OSError):
            pass
        finally:
            async with self._lock:
                if reader is self.reader:   # not already replaced
                    self._drop()

    async def close(self) -> None:
        async with self._lock:
            if self.writer is not None:
                try:
                    self.writer.write(wire.encode_bye("done"))
                    await self.writer.drain()
                except (ConnectionError, OSError):
                    pass
                try:
                    self.writer.close()
                except Exception as e:
                    self.fleet.report.record_close_error(e)
            self.reader = self.writer = None
        if self._rtask is not None:
            self._rtask.cancel()
            try:
                await self._rtask
            except asyncio.CancelledError:
                pass  # our own cancel — the expected path
            except Exception as e:
                self.fleet.report.record_close_error(e)


def _arrival_gaps(cfg: FleetConfig, rng: np.random.Generator) -> list[float]:
    """Seconds between consecutive request launches, per the trace spec."""
    kind, _, spec = cfg.trace.partition(":")
    n = cfg.requests
    if kind == "uniform":
        rate = float(spec)
        return [1.0 / rate] * n
    if kind == "poisson":
        rate = float(spec)
        return [float(g) for g in rng.exponential(1.0 / rate, size=n)]
    if kind == "burst":
        size_s, _, gap_s = spec.partition("@")
        size, gap = int(size_s), float(gap_s) / 1e3
        return [0.0 if (i % size) else gap for i in range(n)]
    raise ValueError(
        f"unknown trace {cfg.trace!r} (want uniform:<rps> | poisson:<rps> "
        f"| burst:<n>@<gap_ms>)"
    )


class ClientFleet:
    def __init__(self, cfg: FleetConfig):
        if cfg.port <= 0:
            raise ValueError("FleetConfig.port must be a bound server port")
        self.cfg = cfg
        self.report = FleetReport()
        self._pending: dict[str, _Pending] = {}
        self._rng = np.random.default_rng(cfg.seed)
        self._chans = [_Chan(self, c) for c in range(max(1, cfg.clients))]

    # -- resolution (reader side) -------------------------------------------
    def _entry(self, rid: str) -> _Pending | None:
        return self._pending.get(rid)

    def _on_result(self, res: wire.WireResult) -> None:
        p = self._entry(res.rid)
        if p is None:
            return                      # not ours (another fleet's rid)
        digest = hashlib.sha1(np.ascontiguousarray(res.payload)).hexdigest()
        if p.outcome is not None:
            self.report.dup_responses += 1
            if p.outcome != "ok" or p.digest != digest:
                self.report.mismatched_dups += 1
            return
        p.outcome = "ok"
        p.digest = digest
        if self.cfg.keep_payloads:
            self.report.payloads[res.rid] = res.payload
        p.engine_rid = res.engine_rid
        p.latency_ms = (time.monotonic() - p.t0) * 1e3
        p.ev.set()

    def _on_reject(self, rej: wire.WireReject) -> None:
        p = self._entry(rej.rid)
        if p is None:
            return
        if p.outcome is not None:
            self.report.dup_responses += 1
            return
        if rej.code in self.cfg.retry_codes:
            p.nacked = True             # wake the sender: backoff + retry
            p.ev.set()
            return
        p.outcome = f"rejected:{rej.code}"
        p.ev.set()

    # -- sending side --------------------------------------------------------
    async def _backoff(self, attempt: int) -> None:
        cfg = self.cfg
        base = min(cfg.backoff_cap_ms, cfg.backoff_base_ms * 2 ** attempt)
        await asyncio.sleep(base * (0.5 + self._rng.random()) / 1e3)

    async def _drive(self, idx: int, req: DeliveryRequest) -> None:
        cfg = self.cfg
        rid = f"{cfg.fleet_id}-{idx}"
        p = _Pending()
        p.t0 = time.monotonic()
        self._pending[rid] = p
        if cfg.keep_payloads:
            self.report.requests[rid] = req
        budget = cfg.timeout_ms / 1e3
        attempt = 0
        while p.outcome is None:
            left = budget - (time.monotonic() - p.t0)
            if left <= 0:
                break
            if attempt >= cfg.max_attempts:
                # Out of sends: wait out the budget for in-flight hedges,
                # then take whatever outcome landed (or none -> timeout).
                try:
                    await asyncio.wait_for(p.ev.wait(), timeout=left)
                except asyncio.TimeoutError:
                    pass
                break
            age_ms = (time.monotonic() - p.t0) * 1e3
            frame = wire.encode_request(req, rid, age_ms=age_ms)
            chan = self._chans[(idx + attempt) % len(self._chans)]
            attempt += 1
            if attempt > 1:
                self.report.hedges += 1
            if not await chan.send(frame):
                self.report.retries += 1
                await self._backoff(attempt)
                continue
            # Wait for a terminal frame, a retryable nack, or the hedge timer.
            wait = min(cfg.attempt_timeout_ms / 1e3,
                       budget - (time.monotonic() - p.t0))
            try:
                await asyncio.wait_for(p.ev.wait(), timeout=max(0.0, wait))
            except asyncio.TimeoutError:
                continue                # hedge: re-send the same rid
            if p.nacked and p.outcome is None:
                p.nacked = False
                p.ev.clear()
                self.report.retries += 1
                await self._backoff(attempt)
        if p.outcome is None:
            p.outcome = "timeout"
        self.report.outcomes[rid] = p.outcome
        if p.outcome == "ok":
            self.report.latencies_ms.append(p.latency_ms)
            self.report.engine_rids[rid] = p.engine_rid

    def _make_request(self, idx: int) -> DeliveryRequest:
        cfg = self.cfg
        if cfg.features is None:
            lane = "rows"
            shape = (cfg.batch, cfg.channels, cfg.image_size, cfg.image_size)
        else:
            lane = "features"
            shape = (cfg.batch, *cfg.features)
        payload = self._rng.standard_normal(shape).astype(np.float32)
        return DeliveryRequest(
            f"tenant-{idx % cfg.tenants}", payload, lane=lane,
            priority=cfg.priority, deadline_ms=cfg.deadline_ms,
        )

    async def run(self) -> FleetReport:
        cfg = self.cfg
        gaps = _arrival_gaps(cfg, self._rng)
        self.report.submitted = cfg.requests
        tasks = []
        t_next = time.monotonic()
        try:
            for i in range(cfg.requests):
                # Open loop: launch on schedule whether or not earlier
                # requests completed.
                delay = t_next - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                tasks.append(
                    asyncio.ensure_future(self._drive(i, self._make_request(i)))
                )
                t_next += gaps[i]
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            for chan in self._chans:
                await chan.close()
        return self.report


async def run_fleet(cfg: FleetConfig) -> FleetReport:
    return await ClientFleet(cfg).run()


# ---------------------------------------------------------------------------
# CLI: optionally spawn the server, run the fleet, check the guarantee.
# ---------------------------------------------------------------------------

def spawn_server(extra_args: list[str], *, device: str | None = None,
                 timeout: float = 120.0):
    """Launch ``python -m repro_torch.launch.serve --mode serve --port 0
    ...`` as a subprocess (on ``device``: the server's default, the card,
    when None) and parse the ephemeral port off its 'serving on host:port'
    line.  Returns ``(process, port)``; the caller owns SIGTERM + wait."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.serve",
        "--mode", "serve", "--port", "0", *extra_args,
    ]
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env,
    )
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"server exited rc={proc.returncode} before binding:\n"
                    + "".join(lines)
                )
            time.sleep(0.05)
            continue
        lines.append(line)
        if line.startswith("serving on "):
            addr = line.split()[2]
            return proc, int(addr.rsplit(":", 1)[1])
    proc.kill()
    raise RuntimeError(
        f"server did not bind within {timeout}s:\n" + "".join(lines)
    )


def stop_server(proc, *, timeout: float = 60.0) -> int:
    """SIGTERM the spawned server and require a clean graceful drain."""
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"server ignored SIGTERM for {timeout}s")
    return proc.returncode


def main(argv=None) -> FleetReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--trace", default="uniform:200")
    ap.add_argument("--timeout-ms", type=float, default=20000.0)
    ap.add_argument("--attempt-timeout-ms", type=float, default=2000.0)
    ap.add_argument("--max-attempts", type=int, default=6)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--retry-draining", action="store_true",
                    help="treat DRAINING rejections as retryable (riding "
                         "across a server restart) instead of terminal")
    ap.add_argument("--chaos", action="store_true",
                    help="client-side network chaos: truncated request "
                         "frames, mid-frame stalls, dropped connections")
    ap.add_argument("--chaos-rate", type=float, default=0.15)
    ap.add_argument("--chaos-seed", type=int, default=1)
    ap.add_argument("--spawn-server", action="store_true",
                    help="launch serve.py --mode serve on an ephemeral port, "
                         "SIGTERM it after the run, require exit code 0")
    ap.add_argument("--device", default=None,
                    help="--device of the spawned server (default: its "
                         "own, the card)")
    ap.add_argument("--server-args", default="",
                    help="extra flags for the spawned server, one string "
                         "(e.g. \"--chaos --max-pending-rows 64\")")
    ap.add_argument("--expect-sheds", action="store_true",
                    help="require at least one OVERLOADED rejection (the "
                         "overload run must shed, not queue)")
    ap.add_argument("--expect-ok-min", type=int, default=1,
                    help="require at least this many 'ok' outcomes")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the fleet report as JSON (CI artifact)")
    args = ap.parse_args(argv)

    chaos = None
    if args.chaos:
        chaos = FailureInjector(
            network_phases={"write", "read", "stall"},
            network_rate=args.chaos_rate,
            stall_ms=150.0,
            seed=args.chaos_seed,
        )
    proc = None
    port = args.port
    try:
        if args.spawn_server:
            proc, port = spawn_server(args.server_args.split(),
                                      device=args.device)
        elif not port:
            ap.error("--port is required unless --spawn-server")
        elif args.device is not None:
            ap.error("--device applies to --spawn-server only")
        cfg = FleetConfig(
            host=args.host, port=port, requests=args.requests,
            clients=args.clients, tenants=args.tenants, batch=args.batch,
            channels=args.channels, image_size=args.image_size,
            trace=args.trace, timeout_ms=args.timeout_ms,
            attempt_timeout_ms=args.attempt_timeout_ms,
            max_attempts=args.max_attempts, deadline_ms=args.deadline_ms,
            seed=args.seed, chaos=chaos,
            retry_codes=(
                frozenset({"DRAINING"}) if args.retry_draining else frozenset()
            ),
        )
        report = asyncio.run(run_fleet(cfg))
    finally:
        if proc is not None:
            rc = stop_server(proc)
            out = proc.stdout.read()
            print(out, end="")
            if rc != 0:
                raise SystemExit(f"server exited rc={rc} after SIGTERM")

    report.assert_exactly_once()
    counts = report.counts()
    if counts.get("ok", 0) < args.expect_ok_min:
        raise SystemExit(
            f"only {counts.get('ok', 0)} ok outcomes "
            f"(need >= {args.expect_ok_min}): {counts}"
        )
    if args.expect_sheds and not counts.get("rejected:OVERLOADED", 0):
        raise SystemExit(f"expected OVERLOADED sheds, got none: {counts}")
    print(
        f"fleet: {report.submitted} rids, outcomes={counts} "
        f"p50={report.quantile_ms(0.5):.1f}ms "
        f"p99={report.quantile_ms(0.99):.1f}ms retries={report.retries} "
        f"hedges={report.hedges} conn_drops={report.conn_drops} "
        f"dup_responses={report.dup_responses}"
    )
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report.as_dict(), f, indent=2)
        print(f"report written to {args.report}")
    return report


if __name__ == "__main__":
    main()
