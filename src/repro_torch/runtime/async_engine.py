"""Async front door for the MoLe delivery engine on PyTorch.

Ported from ``repro.runtime.async_engine``.  ``MoLeDeliveryEngine`` is
deliberately synchronous: ``submit`` then ``flush`` drains everything, so
one slow tenant (or a caller that simply hasn't called ``flush`` yet) stalls
the microbatch clock for everyone.  This module puts a latency-SLO'd,
admission-controlled front door over it:

  * **Typed front door** — :meth:`AsyncDeliveryEngine.submit` takes the same
    :class:`repro_torch.runtime.DeliveryRequest` as the sync engine (any
    lane) and returns a ``concurrent.futures.Future`` resolving to a
    :class:`repro_torch.runtime.DeliveryResult`.
  * **Background flusher** — a daemon thread issues every flush: every
    kernel of a flush is launched from it, on its current stream (the
    device's default stream), and its results reach the host through the
    engine's ``.cpu()`` copies, which wait for the card.
  * **Deadline-driven flushing** — a flush fires when any pending request
    reaches its deadline: per-request ``DeliveryRequest.deadline_ms`` when
    given, the engine-wide ``max_delay_ms`` SLO otherwise — or earlier when
    enough rows have accumulated to fill a microbatch (``flush_rows``).
  * **Per-tenant admission control** — at most ``max_inflight_rows`` rows per
    tenant may be in flight (submitted, not yet completed).  Beyond quota,
    ``admission="block"`` applies backpressure (the submitting thread waits),
    ``admission="reject"`` raises :class:`AdmissionError` immediately.  Both
    outcomes land in ``EngineStats`` per tenant (``rejected_by_tenant`` /
    ``blocked_by_tenant``).
  * **Double-buffered flushing** — a flush is three engine phases
    (``begin_flush`` coalesce / ``execute_flush`` device / ``publish_flush``
    scatter) and the flusher holds ``self._cv`` only for the first and last:
    ``begin_flush`` drains the queues into private work items, so while the
    device step runs *outside the lock*, submitters keep enqueuing into the
    now-empty queues (``EngineStats.submit_stalls`` + submit-wait quantiles
    make that observable).  The work items pin the secret stacks their
    ``gidx`` was built against; a prefetch that patches the plan meanwhile
    clones instead of writing them (``runtime.engine``, "Threads").
  * **Latency accounting** — submit→publish completion latency lands in
    ``EngineStats`` (``p50_ms`` / ``p95_ms``, split per priority), along
    with per-phase flush timing (coalesce/device/publish p50/p95).
  * **Crash safety** — the flusher runs supervised: a ``SimulatedFailure``
    (``resilience.FailureInjector``) at a flush-phase boundary triggers
    in-process recovery (the engine replays every in-flight request from
    its retained payloads — no lost and no duplicated request ids),
    optionally snapshotting between rounds to ``snapshot_dir`` so a killed
    *process* restores via :meth:`restore`.  Anything else marks the engine
    **dead**: pending futures fail with :class:`EngineDeadError` and later
    submits raise immediately instead of blocking forever.

Where the reference fails one round's waiters on an unexpected error in a
flush phase and carries on, the port treats every such error as fatal: a
CUDA or launch error from a kernel wrapper leaves the card in a state no
retry should trust, and nothing here retries on the CPU.

Thread-safety contract: the wrapped engine/queue/registry are only ever
touched while ``self._cv`` is held (by submitters for the engine enqueue, by
the flusher for ``begin_flush``/``publish_flush``/``take_result``) — except
``execute_flush``, which touches only its work items and their pinned plans
(pins are taken and returned only under the lock, by ``begin_flush`` and
``publish_flush``).  Request normalization runs *outside*
the lock.  Future callbacks fire outside the lock.
"""
from __future__ import annotations

import heapq
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as futures_timeout_error

from repro_torch.core.protocol import SlotRegistry

from . import api
from .api import DeliveryRequest
from .engine import MoLeDeliveryEngine
from .resilience import EngineSnapshot, SimulatedFailure

_log = logging.getLogger(__name__)

__all__ = ["AdmissionError", "AsyncDeliveryEngine", "EngineDeadError"]


class AdmissionError(RuntimeError):
    """A tenant exceeded its in-flight row quota under ``admission="reject"``."""


class EngineDeadError(RuntimeError):
    """The background flusher died (an error in a flush phase, or a crash
    after ``max_restarts`` recoveries): in-flight futures were failed with
    this, and submits/drains on the dead engine raise it immediately rather
    than blocking forever on a flush that will never come."""


class AsyncDeliveryEngine:
    """Deadline-flushing, admission-controlled wrapper over the sync engine.

    Parameters
    ----------
    engine:
        A :class:`MoLeDeliveryEngine` or any :class:`SlotRegistry` — vision
        ``SessionRegistry`` or ``LMSessionRegistry`` (a default engine is
        built around a bare registry; ``engine_kwargs`` such as ``device=``,
        whose default is the card, pass through).  Every lane shares the
        deadline flusher and the per-tenant admission quota.
    max_delay_ms:
        Engine-wide latency SLO: a flush starts within this long of any
        request's submission unless that request carried its own
        ``deadline_ms``.
    flush_rows:
        Flush early once this many rows are pending (default: one full
        microbatch, ``max_rows * largest group bucket``).
    max_inflight_rows:
        Per-tenant admission quota, counted submit→completion.
    admission:
        ``"block"`` (backpressure) or ``"reject"`` (:class:`AdmissionError`).
    snapshot_dir:
        When given, the flusher persists an :class:`EngineSnapshot` between
        flush rounds (``snapshot_every``-th round, captured under the lock,
        written off it via the atomic ``CheckpointManager``); after a
        process crash, :meth:`restore` on a fresh front door replays it.
    snapshot_every:
        Snapshot cadence in flush rounds (default: every round).
    max_restarts:
        In-process recoveries allowed before a recoverable flusher crash is
        treated as fatal (:class:`EngineDeadError`).
    prefetch_horizon_ms:
        When set, the flusher runs the engine's *predictive* prefetch after
        each flush round (see :meth:`MoLeDeliveryEngine.predictive_prefetch`;
        hit rate in ``EngineStats.prefetch_hits`` / ``prefetch_misses``).
    injector:
        Optional :class:`repro_torch.runtime.resilience.FailureInjector`,
        assigned to the wrapped engine (tests / serve.py
        ``--inject-failure``).
    """

    def __init__(
        self,
        engine: MoLeDeliveryEngine | SlotRegistry,
        *,
        max_delay_ms: float = 5.0,
        flush_rows: int | None = None,
        max_inflight_rows: int = 4096,
        admission: str = "block",
        snapshot_dir: str | None = None,
        snapshot_every: int = 1,
        max_restarts: int = 3,
        prefetch_horizon_ms: float | None = None,
        injector=None,
        **engine_kwargs,
    ):
        if isinstance(engine, SlotRegistry):
            engine = MoLeDeliveryEngine(engine, **engine_kwargs)
        elif engine_kwargs:
            raise TypeError(
                f"engine_kwargs {sorted(engine_kwargs)} only apply when "
                f"constructing the engine from a registry"
            )
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', got {admission!r}")
        self.engine = engine
        self.max_delay_ms = float(max_delay_ms)
        self.flush_rows = (
            engine.max_rows * engine.group_buckets[-1]
            if flush_rows is None else int(flush_rows)
        )
        self.max_inflight_rows = int(max_inflight_rows)
        self.admission = admission
        if injector is not None:
            engine.injector = injector
        self.snapshot_every = max(1, int(snapshot_every))
        self.max_restarts = int(max_restarts)
        self.prefetch_horizon_ms = (
            None if prefetch_horizon_ms is None else float(prefetch_horizon_ms)
        )
        self._snapshotter = None
        self._snapshot_step = 0
        if snapshot_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager

            self._snapshotter = CheckpointManager(snapshot_dir, keep=3)
            # Number new snapshots above those a previous process left:
            # retention keeps the highest steps, so starting again at 1
            # (as the reference does) would have each new snapshot deleted
            # and a later restore go back to the earlier process's state.
            self._snapshot_step = self._snapshotter.latest_step() or 0
        self._rounds = 0
        self._restarts = 0
        self._dead: BaseException | None = None

        self._cv = threading.Condition()
        self._resolving = 0  # futures popped by the flusher, not yet resolved
        self._futures: dict[int, Future] = {}
        self._submitted_at: dict[int, float] = {}
        # Min-heap of (deadline, rid): the next due deadline is a peek
        # instead of an O(n) scan on every flusher wake.  Deadlines are
        # absolute times — per-request ``deadline_ms`` when the descriptor
        # carried one, submit time + ``max_delay_ms`` otherwise.  Entries
        # whose rid left _submitted_at are stale and lazily popped.
        self._deadline_heap: list[tuple[float, int]] = []
        self._rid_tenant: dict[int, tuple[str, int]] = {}  # rid -> (tenant, rows)
        self._inflight_rows: dict[str, int] = {}
        # Rids whose waiter gave up (cancel-on-timeout): their admission
        # accounting is already released, but their rows may still be queued
        # or mid-flush — the flusher discards the published result instead
        # of leaving it stranded in the engine's buffers.
        self._cancelled: set[int] = set()
        self._force_flush = False
        self._closed = False
        self._flusher = threading.Thread(
            target=self._supervise, name="mole-delivery-flusher", daemon=True
        )
        self._flusher.start()

    # -- public API ----------------------------------------------------------
    @property
    def stats(self):
        return self.engine.stats

    @property
    def registry(self):
        return self.engine.registry

    def pending(self) -> int:
        """Requests submitted but not yet completed."""
        with self._cv:
            return len(self._futures)

    def inflight_rows(self) -> int:
        """Rows admitted but not yet completed, summed over tenants — the
        load-shedding observable the network front door thresholds on."""
        with self._cv:
            return sum(self._inflight_rows.values())

    def prefetch(self, tenant_ids) -> dict[str, int]:
        """Activate tenants' slots + stage their secrets now (see
        :meth:`MoLeDeliveryEngine.prefetch`).

        Runs under the front-door lock: slot assignment and the plan patch
        mutate engine state the flusher also touches.  A flush whose device
        step is running meanwhile keeps the stacks it pinned (the patch
        clones them).  Submitters do block for the staging itself, so
        prefetch in traffic lulls.
        """
        with self._cv:
            return self.engine.prefetch(tenant_ids)

    def _admit(self, req: DeliveryRequest) -> Future:
        """Admission path: quota-gate the engine enqueue under the lock.

        ``req`` is already normalized (outside the lock); rows are the
        admission unit in every lane (images for vision, sequences for
        tokens, positions for features).
        """
        tenant_id = req.tenant_id
        n_rows = api.admission_rows(req)
        t_req = time.monotonic()
        with self._cv:
            # Lock-acquisition wait is the submit-stall observable: with the
            # device step off the lock it must stay flat however long a
            # flush's compute runs.  (Quota waits below are deliberate
            # backpressure, not stalls, and are not counted.)
            self.engine.stats.record_submit_wait_ms(
                (time.monotonic() - t_req) * 1e3
            )
            if self._closed:
                raise RuntimeError("AsyncDeliveryEngine is closed")
            self._check_alive()
            if n_rows > self.max_inflight_rows:
                # Larger than the quota itself: no amount of flushing can
                # ever admit it — blocking would deadlock, so always reject.
                self.engine.stats.rejected += 1
                self.engine.stats.rejected_by_tenant[tenant_id] += 1
                raise AdmissionError(
                    f"request of {n_rows} rows exceeds the per-tenant quota "
                    f"of {self.max_inflight_rows} outright; split it"
                )
            blocked = False
            while (
                self._inflight_rows.get(tenant_id, 0) + n_rows
                > self.max_inflight_rows
            ):
                if self.admission == "reject":
                    self.engine.stats.rejected += 1
                    self.engine.stats.rejected_by_tenant[tenant_id] += 1
                    raise AdmissionError(
                        f"tenant {tenant_id!r} over quota: "
                        f"{self._inflight_rows.get(tenant_id, 0)} rows in "
                        f"flight + {n_rows} submitted > "
                        f"{self.max_inflight_rows} allowed"
                    )
                if not blocked:
                    blocked = True
                    self.engine.stats.blocked += 1
                    self.engine.stats.blocked_by_tenant[tenant_id] += 1
                self._cv.wait()
                if self._closed:
                    raise RuntimeError("AsyncDeliveryEngine is closed")
                self._check_alive()
            rid = self.engine._enqueue_normalized(req)
            fut: Future = Future()
            fut.request_id = rid  # engine request id, for tracing/tests
            self._futures[rid] = fut
            now = time.monotonic()
            self._submitted_at[rid] = now
            delay_s = (
                req.deadline_ms if req.deadline_ms is not None
                else self.max_delay_ms
            ) / 1e3
            heapq.heappush(self._deadline_heap, (now + delay_s, rid))
            self._rid_tenant[rid] = (tenant_id, n_rows)
            self._inflight_rows[tenant_id] = (
                self._inflight_rows.get(tenant_id, 0) + n_rows
            )
            self._cv.notify_all()  # wake the flusher: new deadline / bucket
            return fut

    def submit(self, request: DeliveryRequest) -> Future:
        """Enqueue one :class:`DeliveryRequest` (any lane); the Future
        resolves to a :class:`repro_torch.runtime.DeliveryResult` once a
        deadline/bucket flush completes it."""
        if not isinstance(request, DeliveryRequest):
            raise TypeError(
                f"submit() takes a DeliveryRequest, got "
                f"{type(request).__name__} (the tenant+payload spelling was "
                f"removed; put the payload on the DeliveryRequest)"
            )
        # Normalization (payload validation/conversion) is pure per-request
        # work — run it before taking the lock so it never serializes
        # submitters.
        return self._admit(api.normalize(request, self.engine))

    def deliver(self, request: DeliveryRequest,
                timeout: float | None = None):
        """Synchronous convenience: submit and wait for the
        :class:`DeliveryResult`.

        On ``timeout`` expiry the request is **cancelled** — its admission
        accounting is released and its eventual result discarded — before
        the ``TimeoutError`` propagates; it counts in
        ``EngineStats.timed_out_requests``.
        """
        fut = self.submit(request)
        try:
            return fut.result(timeout=timeout)
        except futures_timeout_error:
            if self.cancel(fut.request_id):
                self.engine.stats.timed_out_requests += 1
            raise

    def cancel(self, rid: int) -> bool:
        """Abandon an in-flight request: release its rid + admission
        accounting now, and have the flusher discard its result when the
        rows (possibly already coalesced into a flush) eventually publish.

        Returns False when the request already completed (or was never
        ours) — the caller lost the race and the result stands.
        """
        with self._cv:
            fut = self._futures.pop(rid, None)
            if fut is None:
                return False
            self._submitted_at.pop(rid, None)
            tenant, n_rows = self._rid_tenant.pop(rid)
            self._inflight_rows[tenant] -= n_rows
            if not self._inflight_rows[tenant]:
                del self._inflight_rows[tenant]
            self._cancelled.add(rid)
            self._cv.notify_all()       # quota freed: wake blocked admitters
        fut.cancel()
        return True

    def flush_now(self) -> None:
        """Ask the flusher to flush immediately (does not wait for results)."""
        with self._cv:
            # Only arm the flag when there is work: a force left dangling on
            # an idle engine would make the next lone request skip its
            # deadline-batching window.
            if self._futures:
                self._force_flush = True
                self._cv.notify_all()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every in-flight request has completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._futures:
                self._force_flush = True
                self._cv.notify_all()
            # _resolving covers the window where the flusher has popped
            # futures but not yet set their results — without it a
            # concurrent close()'s notify could wake us on an empty table
            # with results still pending.
            while self._futures or self._resolving:
                self._check_alive()
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"{len(self._futures) + self._resolving} requests "
                        f"still in flight"
                    )
                self._cv.wait(timeout=left)

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain pending work and stop the flusher (idempotent).

        If the flusher fails to stop within ``timeout`` — a hung device
        step, a wedged callback — the remaining in-flight futures are
        failed and a ``TimeoutError`` (carrying the in-flight count) is
        raised.  The engine is *not* reset: the stuck flusher may still
        publish its round later, and results for cleared rids are simply
        left for ``engine.take()``.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._flusher.join(timeout=timeout)
        if not self._flusher.is_alive():
            if self._snapshotter is not None:
                self._snapshotter.wait()   # last snapshot write is durable
            return
        with self._cv:
            stranded = list(self._futures.values())
            in_flight = len(self._futures) + self._resolving
            self._clear_accounting()
        err = TimeoutError(
            f"flusher did not stop within {timeout}s; "
            f"{in_flight} requests still in flight"
        )
        # Fail the stranded futures outside the lock (callbacks may re-enter).
        for fut in stranded:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(err)
        raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- crash safety ---------------------------------------------------------
    def snapshot_now(self) -> int:
        """Capture and durably persist an engine snapshot immediately,
        outside the flusher's ``snapshot_every`` cadence; returns the
        persisted step.  The network server's graceful drain calls this
        after the backlog flushed, so a restart resumes the same id space
        even when the last cadence snapshot is stale."""
        if self._snapshotter is None:
            raise ValueError("snapshot_now() requires snapshot_dir")
        with self._cv:
            self._check_alive()
            snap = self.engine.snapshot()
            self._snapshot_step += 1
            step = self._snapshot_step
        snap.save(self._snapshotter, step)
        self._snapshotter.wait()          # durable before we report done
        return step

    def restore(self, snapshot: EngineSnapshot | None = None,
                step: int | None = None) -> dict[int, Future]:
        """Rebuild the wrapped engine from a snapshot and re-arm the front
        door's accounting; returns fresh ``{rid: Future}`` for the replayed
        pending requests (they resolve as the flusher re-delivers them).

        ``snapshot=None`` loads the latest persisted one under
        ``snapshot_dir`` (``step`` pins a specific round).  Only valid with
        nothing in flight — a fresh front door after a process restart, or
        after ``drain()``.
        """
        if snapshot is None:
            if self._snapshotter is None:
                raise ValueError(
                    "no snapshot given and no snapshot_dir configured"
                )
            snapshot = EngineSnapshot.load(self._snapshotter, step)
        with self._cv:
            self._check_alive()
            if self._futures or self._resolving:
                raise RuntimeError(
                    f"restore() with {len(self._futures) + self._resolving} "
                    f"requests in flight; drain() first"
                )
            pending = self.engine.restore(snapshot)
            out: dict[int, Future] = {}
            now = time.monotonic()
            for rid in pending:
                req = self.engine._req_info[rid].request
                fut: Future = Future()
                fut.request_id = rid
                self._futures[rid] = fut
                self._submitted_at[rid] = now
                delay_s = (
                    req.deadline_ms if req.deadline_ms is not None
                    else self.max_delay_ms
                ) / 1e3
                heapq.heappush(self._deadline_heap, (now + delay_s, rid))
                n_rows = api.admission_rows(req)
                self._rid_tenant[rid] = (req.tenant_id, n_rows)
                self._inflight_rows[req.tenant_id] = (
                    self._inflight_rows.get(req.tenant_id, 0) + n_rows
                )
                out[rid] = fut
            self._cv.notify_all()   # wake the flusher: replayed deadlines
            return out

    # analysis: requires-lock(_cv)
    def _check_alive(self) -> None:
        """Caller holds ``self._cv``.  Raise instead of letting a caller
        wait on a flusher that will never run again."""
        if self._dead is not None:
            raise EngineDeadError(
                "delivery flusher died; engine no longer accepts work"
            ) from self._dead
        if not self._flusher.is_alive() and not self._closed:
            raise EngineDeadError("delivery flusher thread is not running")

    # analysis: requires-lock(_cv)
    def _clear_accounting(self) -> None:
        """Caller holds ``self._cv``.  Forget every in-flight request."""
        self._futures.clear()
        self._submitted_at.clear()
        self._deadline_heap.clear()
        self._rid_tenant.clear()
        self._inflight_rows.clear()
        self._cancelled.clear()

    def _mark_dead(self, exc: BaseException) -> None:
        with self._cv:
            self._dead = exc
            stranded = list(self._futures.values())
            self._clear_accounting()
            self._resolving = 0
            self.engine.stats.flush_failures += 1
            self.engine.reset_pending()
            self._cv.notify_all()
        # The error class only: its message may embed repr'd payloads.
        _log.error("delivery flusher died with %s: failing %d waiter(s)",
                   type(exc).__name__, len(stranded))
        err = EngineDeadError(
            f"delivery flusher died: {exc!r}; in-flight requests failed"
        )
        err.__cause__ = exc
        # Outside the lock: future callbacks must not deadlock us.
        for fut in stranded:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(err)

    def _supervise(self) -> None:
        """Flusher thread target: run the flush loop under supervision.

        A ``SimulatedFailure`` escaping a phase boundary is the recoverable
        case: the engine replays every in-flight request from its retained
        payloads (:meth:`MoLeDeliveryEngine.requeue_inflight`) under the
        original request ids — waiters keep their futures, nothing is lost,
        nothing delivered twice — and the loop resumes, up to
        ``max_restarts`` times.  Any other escape, **including
        BaseException** (a KeyboardInterrupt delivered into this thread
        would otherwise kill it silently) and a kernel's CUDA error, is
        fatal: :meth:`_mark_dead` fails the in-flight futures with
        :class:`EngineDeadError` and subsequent submits raise immediately.
        """
        while True:
            try:
                self._run()
                return
            except SimulatedFailure as e:
                if self._restarts >= self.max_restarts:
                    self._mark_dead(e)
                    return
                self._restarts += 1
                with self._cv:
                    self.engine.requeue_inflight()
                    # Re-arm: the replayed backlog should flush promptly.
                    self._force_flush = bool(self._futures)
                    self._cv.notify_all()
            except BaseException as e:
                self._mark_dead(e)
                return

    # -- the flusher thread ---------------------------------------------------
    # analysis: requires-lock(_cv)
    def _oldest_deadline(self) -> float | None:
        # Peek the deadline heap, lazily discarding entries whose request
        # already completed (rid no longer in _submitted_at) — amortized
        # O(log n) per request instead of an O(n) min-scan per wake.  The
        # heap holds absolute per-request deadlines, so a request submitted
        # with a tight ``deadline_ms`` surfaces ahead of older requests
        # running on the engine-wide SLO.
        heap = self._deadline_heap
        while heap and heap[0][1] not in self._submitted_at:
            heapq.heappop(heap)
        if not heap:
            return None
        return heap[0][0]

    # analysis: requires-lock(_cv)
    def _should_flush(self, now: float) -> bool:
        if not self._futures:
            return False
        if self._force_flush or self._closed:
            return True
        if self.engine.pending_rows >= self.flush_rows:
            return True
        deadline = self._oldest_deadline()
        return deadline is not None and now >= deadline

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._should_flush(time.monotonic()):
                    if self._closed and not self._futures:
                        return
                    deadline = self._oldest_deadline()
                    timeout = (
                        None if deadline is None
                        else max(0.0, deadline - time.monotonic())
                    )
                    self._cv.wait(timeout=timeout)
                self._force_flush = False
                # Phase 1 under the lock: coalesce the queues into private
                # work items.  Afterwards the queues are empty — the second
                # buffer — and submitters fill them while phase 2 runs.
                work = self.engine.begin_flush()
            # Phase 2 OUTSIDE the lock: the device step (the long pole of a
            # flush) runs while submitters keep acquiring _cv, so submit
            # latency no longer scales with flush duration.
            if work is not None:
                self.engine.execute_flush(work)
            resolved: list[tuple[Future, object]] = []
            with self._cv:
                # Phase 3 under the lock: scatter results into the engine's
                # per-request buffers (cheap bookkeeping).
                done = {} if work is None else self.engine.publish_flush(work)
                for rid in done:
                    # A rid submitted to the sync engine directly (mixed API
                    # use) completes here too but is not ours to resolve —
                    # leave its result for engine.take().
                    fut = self._futures.pop(rid, None)
                    if fut is None:
                        if rid in self._cancelled:
                            # The waiter gave up (cancel-on-timeout): pop and
                            # drop the result so it doesn't strand in the
                            # engine's buffers.
                            self._cancelled.discard(rid)
                            self.engine.take_result(rid)
                        continue
                    self._submitted_at.pop(rid)
                    tenant, n_rows = self._rid_tenant.pop(rid)
                    self._inflight_rows[tenant] -= n_rows
                    if not self._inflight_rows[tenant]:
                        del self._inflight_rows[tenant]
                    # Completion latency (p50/p95, split per priority) was
                    # recorded by the engine at publish time.
                    resolved.append((fut, self.engine.take_result(rid)))
                self._resolving += len(resolved)
            # Resolve outside the lock: user callbacks must not deadlock us.
            # set_running_or_notify_cancel() guards against futures the
            # caller cancelled (e.g. after a result() timeout) — resolving
            # those would raise InvalidStateError and kill this thread.
            for fut, res in resolved:
                if fut.set_running_or_notify_cancel():
                    fut.set_result(res)
            # Notify only after the futures are resolved, so a drain()er
            # waking on an empty in-flight table can rely on .result()
            # being immediate.
            with self._cv:
                self._resolving -= len(resolved)
                self._cv.notify_all()  # quota freed / drain() progress
            # Predictive prefetch in the inter-round slack: stage tenants
            # the arrival predictor expects before their burst lands.  Under
            # the lock (slot assignment + plan patches mutate engine state),
            # but after futures resolved — waiters never wait on staging.
            if self.prefetch_horizon_ms is not None:
                with self._cv:
                    if not self._closed:
                        self.engine.predictive_prefetch(self.prefetch_horizon_ms)
            # Supervised snapshotting between flush rounds: the image is
            # captured under the lock (a consistent cut — publish has
            # completed, nothing is half-scattered) but written *off* it,
            # so disk I/O never blocks submitters.
            if self._snapshotter is not None and work is not None:
                self._rounds += 1
                if self._rounds % self.snapshot_every == 0:
                    with self._cv:
                        snap = self.engine.snapshot()
                        self._snapshot_step += 1
                        step = self._snapshot_step
                    snap.save(self._snapshotter, step)
