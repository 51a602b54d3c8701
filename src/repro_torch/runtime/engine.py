"""Batched multi-tenant MoLe delivery engine on PyTorch.

Ported from ``repro.runtime.engine``: the vision lane and the LM token and
continuous features lanes.  Many provider sessions (one per tenant, each
with its own secrets) are registered in a
:class:`~repro_torch.core.protocol.SessionRegistry` (vision) and/or a
:class:`~repro_torch.core.lm.LMSessionRegistry` (LM);
incoming requests are coalesced into padded microbatches
(``repro_torch.runtime.queue``).  On the vision lane the provider-side morph
plus the developer-side Aug-Conv forward run as two grouped-GEMM launches
over the whole microbatch:

    (G, B, F_in) --morph cores[gidx]--> (G, B, F_in) --@ augs[gidx]--> (G, B, F_out)

Groups never mix tenants, so tenant A's rows are only ever morphed with
tenant A's secrets.  Both steps read each group's secrets **in place** from
the stacked ``(S, ...)`` device tensors through the hand-written CUDA
kernels of :mod:`repro_torch.kernels.grouped`.  On the token lane, prompts
coalesce into length-bucketed ``(G, B, L)`` microbatches and the morph is a
gather through each group's slot of the stacked ``(S, V)`` permutations
(plus, for ``deliver="embed"`` requests, a gather through the ``(S, V, d)``
Aug-Embedding stack, staged only once such a request has been seen).  The
continuous ``features`` lane is the vision math with ``m^2 -> 1``: rows of
per-position features go through the same two grouped kernels with the LM
registry's ``(S, q, q)`` embedding cores and ``(S, d_in, d_out)`` fused
projections.

**Where the engine runs.**  ``device=None`` means the card (``"cuda"``); the
CPU runs only when asked for (``device="cpu"``), and then the kernels'
plain versions run.  Without CUDA and without an explicit CPU device the
constructor raises.

**Stacked secrets and copy-on-write.**  The registry's slots are staged on
the device as ``(S, q, q)`` cores and ``(S, F_in, F_out)`` Aug-Conv
matrices; registration/eviction churn reaches the device as per-slot
copies.  A microbatch's ``gidx`` is built against the slot contents at its
coalesce.  When capacity is below the flushed tenant set, coalescing
microbatch k+1 may evict and reuse a slot that microbatch k (same flush
round, not yet executed) still points at.  The reference's functional
``.at[].set`` patch leaves k's arrays untouched; here a patch writes in
place only while no pending work item holds the stacks, and otherwise
clones them first.  The rule covers every stack of a plan: the vision
cores and Aug-Conv matrices and the LM permutations, AugE tables,
embedding cores and fused projections.

**Threads.**  The async front door (``runtime.async_engine``) runs
``execute_flush`` on its flusher thread outside its lock, while a submitter
may patch the plan under that lock (``prefetch``).  So ``execute_flush``
never touches ``holders``: pins are taken by ``begin_flush`` and returned by
``publish_flush``, both under the front door's lock, where every patch
decides between writing in place and cloning.  The results are on the host
by then, so no kernel still reads the stacks.  A round that fails before
its publish never returns its pins; that costs one clone at the next patch.
Every launch and every patch goes to the thread's current stream, the
device's default stream unless a caller set another, so a patch is ordered
after the kernels queued before it.

**Under a mesh.**  Inside :func:`repro_torch.launch.mesh.mesh_context`
the vision, features and token lanes' device steps take
:func:`repro_torch.sharding.rules.delivery_rules`: the ``(G, B, F)``
microbatch (and its ``gidx``) is ``Shard(0)`` over the dp axes (replicated
where G does not divide), each rank runs K1 and K2 (or the token gathers)
on its own groups through ``to_local()``, so no DTensor reaches a kernel,
and the result comes back a DTensor placed as the microbatch; its groups
are gathered whole (``full_tensor()``) where :meth:`execute_flush` brings
the results to the host.  The port runs SPMD, one process a rank, where
the reference has one controller: every rank registers the same tenants,
submits the same requests and coalesces the same microbatches (the queue
is deterministic).  **The stacked secrets replicate to every rank of the
mesh** (the reference's ``delivery_rules`` stance: every shard may serve
any tenant), so each rank holds every tenant's cores and Aug-Conv
matrices; a mesh must not span ranks outside the provider's trust
boundary.  The mesh is read on the thread that runs the device step: the
async front door's flusher thread has none.  The reference's hints in its
device steps have no counterpart: the microbatch is placed when it is put
on the device, and each step's result keeps that placement.

Not ported, deliberately: ``_delivery_step_small`` (the reference routes
tiny microbatches there on its jnp backend only; on the card both steps are
always the grouped kernels) and the ``backend`` switch
(``repro.kernels.dispatch``: the tensor's device picks the implementation).

This class is **not** thread-safe: the async front door serializes every
call but ``execute_flush`` under its lock.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.d2r import reroll_batch
from repro_torch.core.lm import LMSessionRegistry
from repro_torch.core.protocol import SessionRegistry
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    aug_conv_forward_grouped, aug_embed_grouped, morph_rows_grouped,
    token_morph_grouped,
)
from repro_torch.sharding.hints import ambient_mesh, is_dtensor
from repro_torch.sharding.rules import delivery_rules, shard_tensor

from . import api
from .api import DeliveryRequest, DeliveryResult
from .prefetch import ArrivalPredictor
from .resilience import EngineSnapshot, StragglerMonitor

__all__ = ["EngineStats", "MoLeDeliveryEngine", "resolve_device"]

_log = logging.getLogger(__name__)


def _window_quantile(xs, q: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


def _fmt_num(x: float, nd: int = 2) -> str:
    """Quantile for summary(): 'n/a' instead of 'nan' when nothing was
    recorded, so an idle engine's stats dump stays readable."""
    return "n/a" if x != x else f"{x:.{nd}f}"


def _fmt_ms(x: float) -> str:
    v = _fmt_num(x)
    return v if v == "n/a" else v + "ms"


# Flush phases timed by the engine; EngineStats keeps one reservoir each.
FLUSH_PHASES = ("coalesce", "device", "publish")


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    rows_in: int = 0            # real data rows submitted
    rows_padded: int = 0        # zero rows added by bucketing
    microbatches: int = 0
    flushes: int = 0
    rejected: int = 0           # requests refused by admission control
    blocked: int = 0            # submits that waited on quota backpressure
    # Padding groups whose slot index hit the clamp bound during coalescing:
    # such groups read a real tenant's secrets with all-zero rows (harmless,
    # sliced away) but signal a sparse-table layout CPU serving pays for.
    padding_clamp_count: int = 0
    # Resilience counters: flushes whose device phase the straggler monitor
    # flagged as slow, flush rounds that failed all their waiters, engine
    # snapshots taken, and restores performed.
    degraded_flushes: int = 0
    flush_failures: int = 0
    snapshots: int = 0
    restores: int = 0
    # Submits whose front-door lock wait exceeded stall_threshold_ms: the
    # observable for "the flusher holds the lock across device execution".
    submit_stalls: int = 0
    stall_threshold_ms: float = 1.0
    # Network front door (launch/server.py) counters: requests shed at the
    # door with a typed OVERLOADED rejection (global pending cap or
    # per-tenant admission quota), requests already past their deadline_ms
    # on arrival (EXPIRED), front-door deliver(timeout=) expiries that
    # cancelled their request, connections dropped/reset mid-stream (each
    # one a client reconnect), and retries answered straight from the
    # exactly-once result cache.
    shed_requests: int = 0
    expired_requests: int = 0
    timed_out_requests: int = 0
    reconnects: int = 0
    duplicate_hits: int = 0
    # Per-tenant security budget on the served path: tenant -> log2 of the
    # brute-force attack-success upper bound for the secrets serving that
    # tenant (core.security).  Filled by the network server at registration
    # time; summary() renders it so an operator sees the privacy budget
    # next to the latency budget.
    security_budget_log2: dict = dataclasses.field(default_factory=dict)
    # Predictive prefetch scoreboard: a predicted tenant that next arrives
    # while resident is a hit; a lapsed prediction window (or arriving
    # evicted anyway) is a miss.  The hit rate is the gate on whether the
    # arrival predictor earns its staging bandwidth.
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    # Engine-wire: returns the shared scheduler's per-lane service-unit
    # shares for summary() (None on a bare EngineStats).
    service_share_fn: Callable[[], dict] | None = None
    bucket_shapes: set = dataclasses.field(default_factory=set)
    # Per-tenant admission accounting: how often each tenant was refused
    # (admission="reject") or backpressured (admission="block").
    rejected_by_tenant: collections.Counter = dataclasses.field(
        default_factory=collections.Counter
    )
    blocked_by_tenant: collections.Counter = dataclasses.field(
        default_factory=collections.Counter
    )
    # Completion latencies (ms), submit -> publish, recorded by the engine at
    # publish_flush (and split per request priority when one was given).
    # Bounded reservoir: keeps the most recent window so p50/p95 reflect
    # current traffic, not the whole process lifetime.
    latency_window: int = 4096
    _latencies_ms: collections.deque = dataclasses.field(default=None)
    _latencies_by_priority: dict = dataclasses.field(default=None)
    # Per-flush phase durations (FLUSH_PHASES) + per-submit lock waits, same
    # sliding-window reservoirs.
    _phases_ms: dict = dataclasses.field(default=None)
    _submit_wait_ms: collections.deque = dataclasses.field(default=None)
    # WFQ virtual-time lag (max - min across backlogged tenants) sampled at
    # every begin_flush: persistent lag means some tenant is being served far
    # ahead of another relative to its weighted share.
    _wfq_lag: collections.deque = dataclasses.field(default=None)

    def __post_init__(self):
        if self._latencies_ms is None:
            self._latencies_ms = collections.deque(maxlen=self.latency_window)
        if self._latencies_by_priority is None:
            self._latencies_by_priority = {}
        if self._phases_ms is None:
            self._phases_ms = {
                p: collections.deque(maxlen=self.latency_window)
                for p in FLUSH_PHASES
            }
        if self._submit_wait_ms is None:
            self._submit_wait_ms = collections.deque(
                maxlen=self.latency_window
            )
        if self._wfq_lag is None:
            self._wfq_lag = collections.deque(maxlen=self.latency_window)

    @property
    def padding_fraction(self) -> float:
        total = self.rows_in + self.rows_padded
        return self.rows_padded / total if total else 0.0

    def record_latency_ms(self, ms: float, priority: int | None = None) -> None:
        self._latencies_ms.append(float(ms))
        if priority is not None:
            bucket = self._latencies_by_priority.get(priority)
            if bucket is None:
                bucket = self._latencies_by_priority[priority] = (
                    collections.deque(maxlen=self.latency_window)
                )
            bucket.append(float(ms))

    def latency_quantile_ms(self, q: float, priority: int | None = None) -> float:
        """Empirical latency quantile in ms over the recent window (nan if
        nothing has been recorded); ``priority`` restricts to requests
        submitted at that priority level."""
        if priority is not None:
            return _window_quantile(
                self._latencies_by_priority.get(priority, ()), q
            )
        return _window_quantile(self._latencies_ms, q)

    @property
    def priorities_seen(self) -> tuple[int, ...]:
        """Priority levels with recorded completion latencies (descending)."""
        return tuple(sorted(self._latencies_by_priority, reverse=True))

    @property
    def p50_ms(self) -> float:
        return self.latency_quantile_ms(0.50)

    @property
    def p95_ms(self) -> float:
        return self.latency_quantile_ms(0.95)

    # -- flush-phase timing ---------------------------------------------------
    def record_phase_ms(self, phase: str, ms: float) -> None:
        self._phases_ms[phase].append(float(ms))

    def phase_quantile_ms(self, phase: str, q: float) -> float:
        """Per-flush duration quantile of one phase ('coalesce' | 'device' |
        'publish') over the recent window (nan when never flushed)."""
        return _window_quantile(self._phases_ms[phase], q)

    # -- submit-stall accounting ----------------------------------------------
    def record_submit_wait_ms(self, ms: float) -> None:
        """One front-door submit's lock-acquisition wait; waits above
        ``stall_threshold_ms`` count as stalls."""
        self._submit_wait_ms.append(float(ms))
        if ms > self.stall_threshold_ms:
            self.submit_stalls += 1

    def submit_wait_quantile_ms(self, q: float) -> float:
        return _window_quantile(self._submit_wait_ms, q)

    # -- WFQ accounting -------------------------------------------------------
    def record_wfq_lag(self, lag: float) -> None:
        """Virtual-time spread across backlogged tenants, sampled per flush."""
        self._wfq_lag.append(float(lag))

    def wfq_lag_quantile(self, q: float) -> float:
        return _window_quantile(self._wfq_lag, q)

    def summary(self) -> str:
        """Multi-line human-readable dump (serve.py --stats).  Degrades
        gracefully — quantiles with no samples print 'n/a', never 'nan'."""
        lines = [
            f"requests={self.requests} rows_in={self.rows_in} "
            f"microbatches={self.microbatches} flushes={self.flushes} "
            f"padding={self.padding_fraction:.0%} "
            f"padding_clamps={self.padding_clamp_count}",
            f"completion latency: p50={_fmt_ms(self.p50_ms)} "
            f"p95={_fmt_ms(self.p95_ms)}",
        ]
        for pr in self.priorities_seen:
            lines.append(
                f"  priority {pr:>3}: "
                f"p50={_fmt_ms(self.latency_quantile_ms(0.5, priority=pr))} "
                f"p95={_fmt_ms(self.latency_quantile_ms(0.95, priority=pr))}"
            )
        for p in FLUSH_PHASES:
            lines.append(
                f"flush {p:>8}: p50={_fmt_ms(self.phase_quantile_ms(p, 0.5))} "
                f"p95={_fmt_ms(self.phase_quantile_ms(p, 0.95))}"
            )
        lines.append(
            f"submit wait: p50={_fmt_ms(self.submit_wait_quantile_ms(0.5))} "
            f"p95={_fmt_ms(self.submit_wait_quantile_ms(0.95))} "
            f"stalls(>{self.stall_threshold_ms:g}ms)={self.submit_stalls}"
        )
        admission = (
            f"admission: rejected={self.rejected} blocked={self.blocked}"
        )
        if self.rejected_by_tenant:
            admission += f" rejects_by_tenant={dict(self.rejected_by_tenant)}"
        if self.blocked_by_tenant:
            admission += f" blocks_by_tenant={dict(self.blocked_by_tenant)}"
        lines.append(admission)
        lines.append(
            f"wfq virtual-time lag: p50={_fmt_num(self.wfq_lag_quantile(0.5))} "
            f"p95={_fmt_num(self.wfq_lag_quantile(0.95))} units/weight "
            f"(one engine-wide clock)"
        )
        if self.service_share_fn is not None:
            share = self.service_share_fn()
            if share:
                lines.append(
                    "service share: " + " ".join(
                        f"{lane}={frac:.0%}"
                        for lane, frac in sorted(share.items())
                    )
                )
        predicted = self.prefetch_hits + self.prefetch_misses
        if predicted:
            lines.append(
                f"predictive prefetch: hits={self.prefetch_hits} "
                f"misses={self.prefetch_misses} "
                f"hit_rate={self.prefetch_hits / predicted:.0%}"
            )
        lines.append(
            f"resilience: degraded_flushes={self.degraded_flushes} "
            f"flush_failures={self.flush_failures} "
            f"snapshots={self.snapshots} restores={self.restores}"
        )
        served = (
            self.shed_requests + self.expired_requests
            + self.timed_out_requests + self.reconnects + self.duplicate_hits
        )
        if served:
            lines.append(
                f"front door: shed={self.shed_requests} "
                f"expired={self.expired_requests} "
                f"timed_out={self.timed_out_requests} "
                f"reconnects={self.reconnects} "
                f"duplicate_hits={self.duplicate_hits}"
            )
        if self.security_budget_log2:
            worst = max(self.security_budget_log2.items(), key=lambda kv: kv[1])
            lines.append(
                f"security budget: {len(self.security_budget_log2)} tenants, "
                f"weakest log2 P_bf = {worst[1]:.3g} ({worst[0]})"
            )
        return "\n".join(lines)


@dataclasses.dataclass(eq=False)
class _Plan:
    """Device-side stacked secrets as of registry ``version``.

    ``holders`` counts the pending work items whose ``gidx`` was built
    against these stacks; while it is non-zero a patch clones instead of
    writing in place (see the module docstring).
    """

    version: int
    arrays: dict[str, torch.Tensor]   # name -> (S, ...) stacked per-slot secret
    holders: int = 0


def _host(a: np.ndarray) -> torch.Tensor:
    """A host tensor over ``a`` (copied only if it is read-only or strided,
    as arrays restored from a snapshot may be)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


def _stage(arr: torch.Tensor, slots, fn: Callable[[int], np.ndarray]) -> None:
    for s in slots:
        arr[s].copy_(_host(fn(s)))


def _sync_plan(plan: _Plan | None, registry,
               slot_fns: dict[str, Callable[[int], np.ndarray]],
               device: torch.device,
               dtypes: dict[str, torch.dtype] | None = None) -> _Plan:
    """Bring a device plan up to ``registry.version``.

    ``slot_fns`` maps each stacked-tensor name to the registry's per-slot
    host materializer.  A stack is held in ``dtypes[name]`` where given (the
    host array is cast as it is copied, rounding to nearest even), else in
    the host array's dtype.  Changed slots are copied into the stacks one by
    one; the stacks are allocated once per capacity and rebuilt only when
    the changelog has been trimmed or capacity grew.  A plan that pending work
    holds is never written: it is cloned and the clone patched, so earlier
    work items keep the secrets their ``gidx`` was built against.
    """
    if plan is not None and plan.version == registry.version:
        return plan
    slots = None
    if plan is not None and all(
        a.shape[0] == registry.capacity for a in plan.arrays.values()
    ):
        slots = registry.updates_since(plan.version)
    if slots is None:           # first build, capacity grew, changelog trimmed
        arrays = {}
        for name, fn in slot_fns.items():
            first = _host(fn(0))
            arrays[name] = torch.empty(
                (registry.capacity, *first.shape),
                dtype=(dtypes or {}).get(name, first.dtype), device=device,
            )
            _stage(arrays[name], range(registry.capacity), fn)
        return _Plan(version=registry.version, arrays=arrays)
    if plan.holders:
        plan = _Plan(
            version=plan.version,
            arrays={name: a.clone() for name, a in plan.arrays.items()},
        )
    for name, fn in slot_fns.items():
        _stage(plan.arrays[name], slots, fn)
    plan.version = registry.version
    return plan


@dataclasses.dataclass
class _WorkItem:
    """One coalesced microbatch on its way through a phase-split flush.

    Each item pins the plan its ``gidx`` was built against (``plan.holders``)
    until :meth:`MoLeDeliveryEngine.publish_flush` returns the pin.
    """

    lane: str                   # "vision" | "tokens" | "features"
    mb: object                  # runtime.queue.Microbatch
    plan: _Plan                 # slot secrets as of this item's coalesce
    want_embed: bool = False    # tokens lane: run the Aug-Embedding gather
    out: object = None          # host results, set by execute_flush


@dataclasses.dataclass
class _ReqInfo:
    """Per-request scheduling trace, kept from admission to take_result."""

    request: DeliveryRequest        # normalized descriptor
    submitted_at: float             # time.monotonic() at enqueue
    queue_depth_at_submit: int      # engine-wide pending rows before enqueue
    completed_at: float | None = None   # set when a flush publishes the last row


@dataclasses.dataclass
class _FlushWork:
    """The coalesced work items one flush hands from phase to phase; holds
    everything execute_flush needs so it never touches mutable engine or
    registry state."""

    items: list


class MoLeDeliveryEngine:
    """Multiplexes many tenants' delivery traffic: two grouped kernel
    launches per vision or features microbatch, one slot-indexed gather per
    token microbatch.

    A tenant is a **vision session** (``registry``: :class:`SessionRegistry`)
    or an **LM session** (``lm_registry``: :class:`LMSessionRegistry`); one
    engine can serve either kind or both.  Passing an ``LMSessionRegistry``
    as the positional ``registry`` routes it to the LM lane.

    Every request is a :class:`repro_torch.runtime.DeliveryRequest`
    (validated/normalized once in ``runtime.api``) submitted through
    :meth:`submit`/:meth:`deliver`; results redeem as bare payloads
    (:meth:`take`) or full :class:`DeliveryResult` traces
    (:meth:`take_result`).  Scheduling is weighted fair queueing: registry
    weights set cross-tenant shares, ``DeliveryRequest.priority`` orders
    within a tenant.
    """

    def __init__(
        self,
        registry: SessionRegistry | LMSessionRegistry | None = None,
        device=None,
        *,
        lm_registry: LMSessionRegistry | None = None,
        max_rows: int = 64,
        row_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        group_buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
        seq_buckets: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512),
        max_flush_microbatches: int = 64,
        injector=None,
        scheduler=None,
        clock: Callable[[], float] | None = None,
    ):
        from .queue import FairScheduler, RequestQueue, TokenQueue

        if isinstance(registry, LMSessionRegistry):
            if lm_registry is not None:
                raise ValueError(
                    "two LM registries given (positional + lm_registry=)"
                )
            registry, lm_registry = None, registry
        if registry is None and lm_registry is None:
            raise ValueError("need a vision registry, an LM registry, or both")
        self.device = resolve_device(device)
        self.registry = registry
        self.lm_registry = lm_registry
        self.max_rows = max_rows
        # Bounds one flush round's working set: begin_flush coalesces at
        # most this many microbatches, so peak host memory (padded inputs +
        # materialized outputs held until publish) never scales with the
        # backlog — flush() simply runs more rounds.
        self.max_flush_microbatches = int(max_flush_microbatches)
        self.row_buckets = tuple(sorted(row_buckets))
        self.group_buckets = tuple(sorted(group_buckets))
        self.seq_buckets = tuple(sorted(seq_buckets))
        # One id space across every lane.  Request ids: a plain int (not
        # itertools.count) so snapshot()/restore() can serialize and rebuild
        # the allocator.
        self._next_rid = 0

        def _alloc_rid() -> int:
            rid = self._next_rid
            self._next_rid += 1
            return rid

        self._id_alloc = _alloc_rid
        # One WFQ clock for the engine: every lane (and a decode lane given
        # this scheduler) charges its service units against the same
        # per-tenant records.  Weights resolve through the registries
        # (weight_of), the single source of truth.
        self.scheduler = (
            scheduler if scheduler is not None
            else FairScheduler(weight_of=self._weight_of)
        )
        # Injectable clock (seconds): the arrival predictor and prefetch
        # windows run on it, so tests drive synthetic time.
        self._clock = clock if clock is not None else time.monotonic
        self.predictor = ArrivalPredictor()
        # tenant -> prediction-window deadline (clock seconds): tenants
        # predictive_prefetch staged and is waiting to score.
        self._predicted: dict[str, float] = {}
        self.queue = (
            RequestQueue(
                registry.geom.in_features, max_rows=max_rows,
                row_buckets=self.row_buckets, group_buckets=self.group_buckets,
                id_alloc=self._id_alloc, scheduler=self.scheduler,
                service_lane="vision",
            )
            if registry is not None else None
        )
        self.token_queue = (
            TokenQueue(
                max_rows=max_rows, row_buckets=self.row_buckets,
                group_buckets=self.group_buckets, seq_buckets=self.seq_buckets,
                id_alloc=self._id_alloc, scheduler=self.scheduler,
            )
            if lm_registry is not None else None
        )
        self.embed_queue = (
            RequestQueue(
                lm_registry.d_in, max_rows=max_rows,
                row_buckets=self.row_buckets, group_buckets=self.group_buckets,
                id_alloc=self._id_alloc, scheduler=self.scheduler,
                service_lane="features",
            )
            if lm_registry is not None and lm_registry.has_embed_lane else None
        )
        self.stats = EngineStats()
        self.stats.service_share_fn = self.scheduler.service_share
        # Crash-safety hooks: the injector (resilience.FailureInjector)
        # raises SimulatedFailure at flush-phase boundaries; the straggler
        # monitor watches per-flush device time and flags degraded flushes
        # into EngineStats.degraded_flushes.
        self.injector = injector
        self.straggler = StragglerMonitor()
        self._plan: _Plan | None = None
        self._lm_plan: _Plan | None = None
        # The stacked (S, V, d_model) AugE tables are by far the largest
        # secrets; they are staged to the device only once a deliver="embed"
        # request has been seen — pure token-morph traffic never pays the
        # upload or the device memory.
        self._embed_tables_needed = False
        self._results: dict[int, np.ndarray] = {}
        self._request_shape: dict[int, tuple[int, ...]] = {}
        self._token_deliver: dict[int, str] = {}   # rid -> "tokens" | "embed"
        self._embed_shape: dict[int, tuple[int, ...]] = {}  # features rid -> out
        self._req_info: dict[int, _ReqInfo] = {}
        self._done: set[int] = set()

    @property
    def pending_rows(self) -> int:
        """Unscheduled rows across every lane (rows == sequences for tokens,
        positions for features)."""
        lanes = (self.queue, self.token_queue, self.embed_queue)
        return sum(q.pending_rows for q in lanes if q is not None)

    def _registry_of(self, tenant_id: str):
        """The registry holding ``tenant_id`` (vision first, then LM; None
        when unknown)."""
        if self.registry is not None and tenant_id in self.registry:
            return self.registry
        if self.lm_registry is not None and tenant_id in self.lm_registry:
            return self.lm_registry
        return None

    def _weight_of(self, tenant_id: str) -> float:
        """The scheduler's weight resolver: registry weights are re-read on
        every submit so ``set_weight`` takes effect immediately."""
        reg = self._registry_of(tenant_id)
        return reg.weight_of(tenant_id) if reg is not None else 1.0

    # -- secrets ------------------------------------------------------------
    def prefetch(self, tenant_ids) -> dict[str, int]:
        """Activate tenants' slots and stage their secrets on the device
        **now**, off the serving critical path.

        ``slot_for`` activates an evicted tenant lazily — but then the
        host->device copy of its secrets lands inside the next flush's
        coalesce phase.  Activation order is the given order, so prefetching
        more tenants than the registry has slots keeps the **last**
        ``capacity`` of them resident (plain LRU).  Returns {tenant_id: slot}.
        """
        slots: dict[str, int] = {}
        touched_vision = touched_lm = False
        for t in tenant_ids:
            reg = self._registry_of(t)
            if reg is None:
                raise KeyError(f"unknown tenant {t!r}")
            slots[t] = reg.slot_for(t)
            touched_vision |= reg is self.registry
            touched_lm |= reg is self.lm_registry
        # The next flush's plan re-sync then finds version current.
        if touched_vision:
            self._refresh_plan()
        if touched_lm:
            self._refresh_lm_plan()
        return slots

    def predictive_prefetch(self, horizon_ms: float = 50.0,
                            now: float | None = None) -> list[str]:
        """Stage evicted tenants the arrival predictor expects within
        ``horizon_ms``: each front-door submission feeds the per-tenant
        EWMA/periodicity estimator, and this call — made whenever the
        caller has slack — prefetches the due ones so their host->device
        secret upload happens *before* the burst instead of inside its first
        flush.  Predictions are scored on the tenant's next arrival:
        submitted-while-resident is a hit, window lapsed (or arrived evicted
        anyway) a miss (``EngineStats.prefetch_hits`` / ``prefetch_misses``).
        Returns the tenants staged this call.
        """
        if now is None:
            now = self._clock()
        # Score prediction windows that lapsed without an arrival.
        for t, deadline in list(self._predicted.items()):
            if now > deadline:
                del self._predicted[t]
                self.stats.prefetch_misses += 1
        due: list[str] = []
        for t in self.predictor.due(horizon_ms / 1e3, now):
            if t in self._predicted:
                continue        # already staged, window still open
            reg = self._registry_of(t)
            if reg is None or reg.is_resident(t):
                continue        # unknown, or nothing to stage
            due.append(t)
        if due:
            self.prefetch(due)
            for t in due:
                iv = self.predictor.interval(t) or 0.0
                # The window closes one horizon + two intervals out: enough
                # slack that a slightly-late periodic tick still scores the
                # prefetch that actually served it.
                self._predicted[t] = now + horizon_ms / 1e3 + 2 * iv
        return due

    def _observe_arrival(self, tenant_id: str) -> None:
        """Feed the arrival predictor and score any open prediction."""
        now = self._clock()
        deadline = self._predicted.pop(tenant_id, None)
        if deadline is not None:
            reg = self._registry_of(tenant_id)
            if reg is not None and reg.is_resident(tenant_id) and now <= deadline:
                self.stats.prefetch_hits += 1
            else:
                self.stats.prefetch_misses += 1
        self.predictor.observe(tenant_id, now)

    def _refresh_plan(self) -> _Plan:
        reg = self.registry
        changed = self._plan is None or self._plan.version != reg.version
        self._plan = _sync_plan(
            self._plan, reg,
            {"cores": reg.slot_core, "augs": reg.slot_aug}, self.device,
        )
        if changed:
            # Make the tenant count and the slot capacity group buckets: the
            # steady-state "every tenant active" microbatch of a capacity-
            # sized registry then lands exactly on G == tenant count (no
            # padding groups).
            self.queue.ensure_group_bucket(len(reg))
            self.queue.ensure_group_bucket(reg.capacity)
        return self._plan

    def _refresh_lm_plan(self) -> _Plan:
        reg = self.lm_registry
        slot_fns = {"perms": reg.slot_perm}
        if self._embed_tables_needed:
            slot_fns["aug_embeds"] = reg.slot_aug_embedding
        if reg.has_embed_lane:
            slot_fns["embed_cores"] = reg.slot_embed_core
            slot_fns["aug_projs"] = reg.slot_aug_projection
        prev = self._lm_plan
        if prev is not None and set(prev.arrays) != set(slot_fns):
            prev = None   # lane set changed (first embed request): rebuild
        changed = prev is None or prev.version != reg.version
        self._lm_plan = _sync_plan(prev, reg, slot_fns, self.device)
        if changed:
            for q in (self.token_queue, self.embed_queue):
                if q is not None:
                    q.ensure_group_bucket(len(reg))
                    q.ensure_group_bucket(reg.capacity)
        return self._lm_plan

    # -- request intake: the typed front door --------------------------------
    def submit(self, request: DeliveryRequest) -> int:
        """Enqueue one :class:`~repro_torch.runtime.DeliveryRequest`.

        Returns a request id redeemable after :meth:`flush` via
        :meth:`take` / :meth:`take_result`.
        """
        return self._submit_request(request)

    def _submit_request(self, request: DeliveryRequest) -> int:
        return self._enqueue_normalized(api.normalize(request, self))

    def _enqueue_normalized(self, req: DeliveryRequest, *,
                            rid: int | None = None,
                            count_stats: bool = True) -> int:
        """Queue an already-:func:`api.normalize`-d request.

        ``rid`` pins the request id instead of allocating a fresh one —
        crash recovery (:meth:`restore` / :meth:`requeue_inflight`) replays
        in-flight requests under their original ids; such replays pass
        ``count_stats=False`` so a request is counted once however many
        crashes it survives.
        """
        depth = self.pending_rows
        if count_stats:
            # Replays are re-deliveries, not arrivals: feeding them to the
            # predictor would corrupt the inter-arrival history.
            self._observe_arrival(req.tenant_id)
        if req.lane == "rows":
            g = self.registry.geom
            rid = self.queue.submit(
                req.tenant_id, req.payload, priority=req.priority, rid=rid
            )
            n_rows = req.payload.shape[0]
            self._request_shape[rid] = (n_rows, g.beta, g.n, g.n)
        elif req.lane == "tokens":
            rid = self.token_queue.submit(
                req.tenant_id, req.payload, priority=req.priority, rid=rid
            )
            n_rows, L = req.payload.shape
            if req.deliver == "embed":
                self._embed_tables_needed = True
            self._token_deliver[rid] = req.deliver
            self._request_shape[rid] = (
                (n_rows, L) if req.deliver == "tokens"
                else (n_rows, L, self.lm_registry.d_model)
            )
        else:  # features: one queue row per position
            reg = self.lm_registry
            rows = req.payload.reshape(-1, reg.d_in)
            rid = self.embed_queue.submit(
                req.tenant_id, rows, priority=req.priority, rid=rid
            )
            n_rows = rows.shape[0]
            self._request_shape[rid] = (n_rows, reg.d_out)
            self._embed_shape[rid] = req.payload.shape[:-1] + (reg.d_out,)
        self._req_info[rid] = _ReqInfo(
            request=req, submitted_at=time.monotonic(),
            queue_depth_at_submit=depth,
        )
        if count_stats:
            self.stats.requests += 1
            self.stats.rows_in += n_rows
        return rid

    # -- the device step -----------------------------------------------------
    def _put(self, a: np.ndarray, logical: tuple) -> torch.Tensor:
        """A host array of the microbatch on the engine's device; under a
        mesh, placed by ``delivery_rules`` from its logical axes."""
        t = torch.from_numpy(a).to(self.device)
        mesh = ambient_mesh()
        if mesh is None:
            return t
        spec = delivery_rules(mesh).spec_for(logical, tuple(t.shape))
        return shard_tensor(t, mesh, spec)

    def _execute(self, x: np.ndarray, gidx: np.ndarray,
                 plan: _Plan) -> torch.Tensor:
        return _delivery_step(
            self._put(x, ("group", "rows", "features")),
            self._put(gidx, ("group",)),
            plan.arrays["cores"], plan.arrays["augs"], self.registry.kappa,
        )

    def _execute_tokens(self, tokens: np.ndarray, gidx: np.ndarray,
                        want_embed: bool, plan: _Plan):
        return _lm_delivery_step(
            self._put(tokens, ("group", "rows", None)),
            self._put(gidx, ("group",)),
            plan.arrays["perms"],
            plan.arrays["aug_embeds"] if want_embed else None,
        )

    def _execute_features(self, x: np.ndarray, gidx: np.ndarray,
                          plan: _Plan) -> torch.Tensor:
        # The continuous LM lane is the vision math (m^2 -> 1): the same
        # step, with the registry's embedding cores and fused projections.
        return _delivery_step(
            self._put(x, ("group", "rows", "features")),
            self._put(gidx, ("group",)),
            plan.arrays["embed_cores"], plan.arrays["aug_projs"],
            self.lm_registry.kappa,
        )

    # -- phase-split flushing -------------------------------------------------
    def _note_microbatch(self, mb) -> None:
        self.stats.microbatches += 1
        self.stats.rows_padded += mb.n_padded_rows
        self.stats.bucket_shapes.add(mb.x.shape[:2])
        self.stats.padding_clamp_count += mb.n_clamped_padding

    def begin_flush(self) -> _FlushWork | None:
        """Phase 1 (cheap, engine-state-mutating): coalesce pending rows
        into microbatch work items, each pinning the device plan its
        ``gidx`` was built against.  At most ``max_flush_microbatches``
        items are taken per call so one round's working set stays bounded
        however deep the backlog; the caller loops until None, which is
        returned when nothing is pending.
        """
        vision_live = self.registry is not None and len(self.registry) > 0
        lm_live = self.lm_registry is not None and len(self.lm_registry) > 0
        if not vision_live and not lm_live:
            return None  # nothing registered yet -> nothing can be pending
        t0 = time.monotonic()
        work = _FlushWork(items=[])
        cap = self.max_flush_microbatches
        lanes = []
        if vision_live:
            self._refresh_plan()  # sync group buckets before coalescing
            lanes.append(
                ("vision", self.queue, self.registry, self._refresh_plan)
            )
        if lm_live:
            self._refresh_lm_plan()
            lanes.append(
                ("tokens", self.token_queue, self.lm_registry,
                 self._refresh_lm_plan)
            )
            if self.embed_queue is not None:
                lanes.append(
                    ("features", self.embed_queue, self.lm_registry,
                     self._refresh_lm_plan)
                )
        # WFQ lag sampled pre-coalesce: the spread the scheduler is about
        # to work off (one sample per flush: the clock is engine-wide).
        self.stats.record_wfq_lag(self.scheduler.wfq_lag())
        clamped = 0
        # Round-robin the microbatch cap across the live lanes, so one
        # lane's backlog cannot take the whole round.  slot_for activates
        # (and LRU-touches) each tenant on lookup, so evicted tenants
        # transparently regain a slot; max_groups caps a microbatch at
        # `capacity` distinct tenants so activations within one coalesce can
        # never evict each other.  The plan re-sync after each coalesce pins
        # the slots that microbatch's gidx was built against (copy-on-write
        # when a later coalesce evicts).
        live = list(lanes)
        while live and len(work.items) < cap:
            for entry in list(live):
                if len(work.items) >= cap:
                    break
                lane, queue, reg, refresh = entry
                mb = queue.coalesce(reg.slot_for, max_groups=reg.capacity)
                if mb is None:
                    live.remove(entry)
                    continue
                self._note_microbatch(mb)
                clamped += mb.n_clamped_padding
                # A token microbatch may mix "tokens" and "embed" requests;
                # the Aug-Embedding gather runs only when one asked for
                # features.
                want_embed = lane == "tokens" and any(
                    self._token_deliver[sl.request_id] == "embed"
                    for sl in mb.slices
                )
                plan = refresh()
                plan.holders += 1
                work.items.append(_WorkItem(lane, mb, plan, want_embed))
        if not work.items:
            return None
        if clamped:
            # Once per flush, not per microbatch: enough to make a sparse-
            # table layout regression observable without log spam.
            _log.warning(
                "coalesce clamped %d out-of-range padding slot indices this "
                "flush (total %d); see EngineStats.padding_clamp_count",
                clamped, self.stats.padding_clamp_count,
            )
        self.stats.flushes += 1
        self.stats.record_phase_ms("coalesce", (time.monotonic() - t0) * 1e3)
        # The coalesced rows have already left the queue, so a failure here
        # strands them unless recovery replays from _req_info.  (The pins of
        # a dropped round are never released; that costs at most one extra
        # clone on the next patch.)
        if self.injector is not None:
            self.injector.maybe_fail_phase("coalesce")
        return work

    def execute_flush(self, work: _FlushWork) -> None:
        """Phase 2 (device compute, no engine-state mutation): launch the
        delivery step of every work item against its pinned plan, then copy
        the results to the host.

        Every microbatch is launched before any result is read back, so the
        card runs them back to back; the device phase time includes the
        copies back, which wait for the card.  Under a mesh each result's
        groups are gathered whole from the ranks first.
        """
        if self.injector is not None:
            self.injector.maybe_fail_phase("device")
        t0 = time.monotonic()
        outs = []
        for item in work.items:
            mb = item.mb
            if item.lane == "vision":
                outs.append(self._execute(mb.x, mb.group_tenant, item.plan))
            elif item.lane == "tokens":
                outs.append(self._execute_tokens(
                    mb.x, mb.group_tenant, item.want_embed, item.plan
                ))
            else:
                outs.append(self._execute_features(
                    mb.x, mb.group_tenant, item.plan
                ))
        for item, out in zip(work.items, outs):
            if item.lane == "tokens":
                morphed, feats = out
                item.out = (
                    _to_host(morphed),
                    None if feats is None else _to_host(feats),
                )
            else:
                item.out = _to_host(out)
        dt_ms = (time.monotonic() - t0) * 1e3
        self.stats.record_phase_ms("device", dt_ms)
        # Straggler watch: a device phase far above the running EMA flags
        # this flush as degraded.
        if self.straggler.record(self.stats.flushes, dt_ms / 1e3):
            self.stats.degraded_flushes += 1
            _log.warning(
                "degraded flush #%d: device phase %.2fms vs EMA %.2fms",
                self.stats.flushes, dt_ms, self.straggler.ema * 1e3,
            )

    def publish_flush(self, work: _FlushWork) -> dict[int, np.ndarray]:
        """Phase 3 (cheap, engine-state-mutating): scatter executed results
        into per-request buffers and mark completed requests done.

        First returns the work items' pins: their results are on the host,
        so the stacks are free to be patched in place again.  (Here and not
        in :meth:`execute_flush`, which the async front door runs off its
        lock: every pin and every patch decision stays under that lock.)
        """
        for item in work.items:
            item.plan.holders -= 1
        # Injected *before* any scatter: publish is all-or-nothing per
        # round, so recovery never sees a half-published flush.
        if self.injector is not None:
            self.injector.maybe_fail_phase("publish")
        t0 = time.monotonic()
        done: dict[int, np.ndarray] = {}
        for item in work.items:
            if item.lane == "vision":
                self._publish_rows(item, done, self._finish_vision)
            elif item.lane == "tokens":
                self._publish_tokens(item, done)
            else:
                self._publish_rows(item, done, self._finish_features)
        self.stats.record_phase_ms("publish", (time.monotonic() - t0) * 1e3)
        return done

    def _mark_done(self, rid: int) -> None:
        """Stamp completion: the request's latency (with its priority) lands
        in the stats the moment its last row is published."""
        self._done.add(rid)
        info = self._req_info.get(rid)
        if info is not None and info.completed_at is None:
            info.completed_at = time.monotonic()
            self.stats.record_latency_ms(
                (info.completed_at - info.submitted_at) * 1e3,
                priority=info.request.priority,
            )

    def _finish_vision(self, rid: int, buf: np.ndarray) -> np.ndarray:
        shape = self._request_shape[rid]
        return reroll_batch(buf, shape[1], shape[2])

    def _finish_features(self, rid: int, buf: np.ndarray) -> np.ndarray:
        return buf.reshape(self._embed_shape[rid])

    def _publish_rows(self, item: _WorkItem, done: dict[int, np.ndarray],
                      finish: Callable[[int, np.ndarray], np.ndarray]) -> None:
        """Scatter a row-lane item's output into its requests' buffers;
        ``finish`` shapes a completed request's rows (vision: re-rolled
        feature maps; features: the request's leading dims)."""
        out = item.out
        for s in item.mb.slices:
            shape = self._request_shape[s.request_id]
            buf = self._results.setdefault(
                s.request_id,
                np.empty((shape[0], out.shape[-1]), np.float32),
            )
            buf[s.req_offset : s.req_offset + s.n_rows] = out[
                s.group, s.group_offset : s.group_offset + s.n_rows
            ]
            if s.req_offset + s.n_rows == shape[0]:
                done[s.request_id] = finish(s.request_id, buf)
                self._results[s.request_id] = done[s.request_id]
                self._mark_done(s.request_id)

    def _publish_tokens(self, item: _WorkItem,
                        done: dict[int, np.ndarray]) -> None:
        morphed, feats = item.out
        seq = item.mb.x.shape[2]     # this lane's padded sequence bucket
        for s in item.mb.slices:
            rid = s.request_id
            shape = self._request_shape[rid]   # (b, L) or (b, L, d)
            embed = self._token_deliver[rid] == "embed"
            buf = self._results.get(rid)
            if buf is None:
                buf = self._results[rid] = (
                    np.empty((shape[0], seq, feats.shape[-1]), np.float32)
                    if embed else np.empty((shape[0], seq), np.int32)
                )
            src = feats if embed else morphed
            buf[s.req_offset : s.req_offset + s.n_rows] = src[
                s.group, s.group_offset : s.group_offset + s.n_rows
            ]
            if s.req_offset + s.n_rows == shape[0]:
                # Strip the sequence padding back to the true length.
                done[rid] = np.ascontiguousarray(buf[:, : shape[1]])
                self._results[rid] = done[rid]
                self._mark_done(rid)

    def flush(self) -> dict[int, np.ndarray]:
        """Run every pending request through padded microbatches.

        Chains :meth:`begin_flush` -> :meth:`execute_flush` ->
        :meth:`publish_flush`, in rounds of at most
        ``max_flush_microbatches``.  Returns {request_id: result} for all
        requests completed during this flush (results are also retained
        until redeemed via :meth:`take`): vision requests resolve to
        features (b, beta, n, n), token requests to morphed tokens (b, L)
        or Aug-embedded features (b, L, d_model), features requests to
        projected features of their own leading shape, (b, L, d_out) or
        (n, d_out).
        """
        done: dict[int, np.ndarray] = {}
        while True:
            work = self.begin_flush()
            if work is None:
                return done
            self.execute_flush(work)
            done.update(self.publish_flush(work))

    def take_result(self, request_id: int) -> DeliveryResult:
        """Redeem a completed request as a :class:`DeliveryResult` (pops it):
        the delivered payload plus the per-request scheduling trace."""
        if request_id not in self._done:
            if request_id in self._request_shape:
                n_rows = self._request_shape[request_id][0]
                state = (
                    "partially delivered" if request_id in self._results
                    else "queued"
                )
                raise KeyError(
                    f"request {request_id} is still pending ({n_rows} rows, "
                    f"{state}; not yet completed by a flush) — call flush() "
                    f"before take()"
                )
            raise KeyError(
                f"unknown request id {request_id}: never submitted or already "
                f"taken ({len(self._done)} completed requests await take())"
            )
        out = self._results.pop(request_id)
        self._request_shape.pop(request_id, None)
        self._token_deliver.pop(request_id, None)
        self._embed_shape.pop(request_id, None)
        self._done.discard(request_id)
        info = self._req_info.pop(request_id)
        req = info.request
        return DeliveryResult(
            request_id=request_id, tenant_id=req.tenant_id, lane=req.lane,
            deliver=req.deliver, priority=req.priority, payload=out,
            submitted_at=info.submitted_at, completed_at=info.completed_at,
            queue_depth_at_submit=info.queue_depth_at_submit,
            metadata=req.metadata,
        )

    def take(self, request_id: int) -> np.ndarray:
        """Redeem a completed request's payload (pops it)."""
        return self.take_result(request_id).payload

    def deliver(self, request: DeliveryRequest) -> DeliveryResult:
        """Submit one request, flush, and return its :class:`DeliveryResult`."""
        rid = self._submit_request(request)
        self.flush()
        return self.take_result(rid)

    def reset_pending(self) -> None:
        """Drop every queued request and unredeemed result (failure reset).
        The id allocator survives, so request ids stay process-unique."""
        self._rebuild_queues()
        self._results.clear()
        self._request_shape.clear()
        self._token_deliver.clear()
        self._embed_shape.clear()
        self._req_info.clear()
        self._done.clear()

    def _rebuild_queues(self) -> None:
        """Replace every lane's queue with an empty twin (same buckets, same
        id allocator).  Crash recovery's first step: a queue abandoned mid-
        coalesce may have rows missing; rebuilding and replaying from
        ``_req_info`` is the only state the recovery paths trust."""
        from .queue import RequestQueue, TokenQueue

        if self.queue is not None:
            # release() hands the dead queue's backlog references back to
            # the scheduler — otherwise its clock would count them as live
            # forever.
            self.queue.release()
            self.queue = RequestQueue(
                self.queue.feature_dim, max_rows=self.max_rows,
                row_buckets=self.queue.row_buckets,
                group_buckets=self.queue.group_buckets,
                dtype=self.queue.dtype, id_alloc=self._id_alloc,
                scheduler=self.scheduler, service_lane="vision",
            )
        if self.token_queue is not None:
            tq = self.token_queue
            tq.release()
            self.token_queue = TokenQueue(
                max_rows=self.max_rows, row_buckets=tq.row_buckets,
                group_buckets=tq.group_buckets, seq_buckets=tq.seq_buckets,
                id_alloc=self._id_alloc, scheduler=self.scheduler,
            )
            # Carry the ensured group buckets over: the LM plan may still be
            # current, so _refresh_lm_plan would not re-ensure them.
            for g in sorted(tq._ensured_groups):
                self.token_queue.ensure_group_bucket(g)
        if self.embed_queue is not None:
            eq = self.embed_queue
            eq.release()
            self.embed_queue = RequestQueue(
                eq.feature_dim, max_rows=self.max_rows,
                row_buckets=eq.row_buckets, group_buckets=eq.group_buckets,
                dtype=eq.dtype, id_alloc=self._id_alloc,
                scheduler=self.scheduler, service_lane="features",
            )

    # -- crash safety: snapshot / restore ------------------------------------
    def snapshot(self) -> EngineSnapshot:
        """Capture an in-memory crash-recovery image of the delivery plane.

        Arrays: the registry's per-tenant secrets (under ``vision/``) plus,
        per un-taken request, either its normalized payload
        (``req/<rid>/payload``, still pending) or its finished result
        (``req/<rid>/result``).  Meta: slot bookkeeping, the scheduler's
        fairness state, and one JSON-able descriptor per request.  The
        layout is the reference's (secrets under ``vision/`` and ``lm/``).
        """
        arrays: dict[str, np.ndarray] = {}
        meta: dict = {
            "next_rid": self._next_rid,
            "embed_tables_needed": self._embed_tables_needed,
            # Restoring the fairness state means a tenant's banked debt
            # survives a crash.
            "scheduler": self.scheduler.snapshot_state(),
            "registries": {},
            "requests": [],
        }
        for lane, reg in (("vision", self.registry), ("lm", self.lm_registry)):
            if reg is None:
                meta["registries"][lane] = None
                continue
            rmeta, rarrays = reg.snapshot_state()
            meta["registries"][lane] = rmeta
            for k, v in rarrays.items():
                arrays[f"{lane}/{k}"] = v
        for rid in sorted(self._req_info):
            info = self._req_info[rid]
            req = info.request
            md = req.metadata
            try:
                json.dumps(md)
            except TypeError:
                md = {}   # opaque caller annotations may not serialize
            done = rid in self._done
            meta["requests"].append({
                "rid": rid, "tenant": req.tenant_id, "lane": req.lane,
                "deliver": req.deliver, "priority": req.priority,
                "deadline_ms": req.deadline_ms, "metadata": md, "done": done,
                "submitted_at": info.submitted_at,
                "completed_at": info.completed_at,
                "queue_depth": info.queue_depth_at_submit,
            })
            if done:
                arrays[f"req/{rid:08d}/result"] = self._results[rid]
            else:
                arrays[f"req/{rid:08d}/payload"] = np.asarray(req.payload)
        self.stats.snapshots += 1
        # analysis: declassified(crash image: held in memory by the caller)
        return EngineSnapshot(arrays=arrays, meta=meta)

    def restore(self, snap: EngineSnapshot) -> list[int]:
        """Rebuild this engine from a :meth:`snapshot` image and return the
        still-pending request ids (submission order).

        Works on a freshly constructed engine whose registry matches the
        snapshot's geometry (validated by the registry), or in place over a
        live one.  The device plan is dropped and re-staged on the next
        flush.  Pending requests re-enter the queue under their original ids
        with their original scheduling traces; finished-but-untaken results
        are restored verbatim, so every submitted id is delivered exactly
        once.
        """
        meta, arrays = snap.meta, snap.arrays
        for lane, reg in (("vision", self.registry), ("lm", self.lm_registry)):
            rmeta = meta["registries"].get(lane)
            if (rmeta is None) != (reg is None):
                raise ValueError(
                    f"snapshot and engine disagree on the {lane} registry "
                    f"(snapshot {'has' if rmeta else 'lacks'} one)"
                )
            if reg is None:
                continue
            prefix = lane + "/"
            reg.restore_state(
                rmeta,
                {k[len(prefix):]: v for k, v in arrays.items()
                 if k.startswith(prefix)},
            )
        self._plan = None
        self._lm_plan = None
        self._embed_tables_needed = bool(meta["embed_tables_needed"])
        self.reset_pending()
        # After reset_pending the queue is drained (no backlog refs), so the
        # scheduler state can be swapped wholesale; the replay below
        # re-enters each pending tenant's backlog through submit.
        if meta.get("scheduler") is not None:
            self.scheduler.restore_state(meta["scheduler"])
        pending: list[int] = []
        for desc in meta["requests"]:
            rid = int(desc["rid"])
            md = desc.get("metadata") or {}
            if desc["done"]:
                self._results[rid] = arrays[f"req/{rid:08d}/result"]
                self._done.add(rid)
                self._req_info[rid] = _ReqInfo(
                    request=DeliveryRequest(
                        desc["tenant"], None, lane=desc["lane"],
                        deliver=desc["deliver"],
                        priority=int(desc["priority"]),
                        deadline_ms=desc["deadline_ms"], metadata=md,
                    ),
                    submitted_at=desc["submitted_at"],
                    queue_depth_at_submit=int(desc["queue_depth"]),
                    completed_at=desc["completed_at"],
                )
            else:
                req = DeliveryRequest(
                    desc["tenant"], arrays[f"req/{rid:08d}/payload"],
                    lane=desc["lane"], deliver=desc["deliver"],
                    priority=int(desc["priority"]),
                    deadline_ms=desc["deadline_ms"], metadata=md,
                )
                self._enqueue_normalized(req, rid=rid, count_stats=False)
                info = self._req_info[rid]
                info.submitted_at = desc["submitted_at"]
                info.queue_depth_at_submit = int(desc["queue_depth"])
                pending.append(rid)
        self._next_rid = max(self._next_rid, int(meta["next_rid"]))
        self.stats.restores += 1
        return pending

    def requeue_inflight(self) -> list[int]:
        """In-process crash recovery: rebuild the (possibly half-coalesced)
        queue and replay every not-yet-done request under its original id.

        Called when a flush round dies between phases: the coalesced work
        items are lost with the round, but ``_req_info`` still holds every
        in-flight request's normalized payload — re-enqueuing those (and
        dropping any partially filled result buffers) makes the next round
        deliver each exactly once.  Finished-but-untaken results are
        untouched.  Returns the replayed ids in submission order.
        """
        self._rebuild_queues()
        pending = sorted(set(self._req_info) - self._done)
        for rid in pending:
            self._results.pop(rid, None)   # drop partial row buffers
            info = self._req_info[rid]
            self._enqueue_normalized(
                info.request, rid=rid, count_stats=False
            )
            self._req_info[rid] = info     # keep the original trace
        return pending


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device result on the host; a DTensor's groups gathered whole."""
    if is_dtensor(t):
        t = t.full_tensor()
    return t.cpu().numpy()


def _on_local_groups(fn, x: torch.Tensor, gidx: torch.Tensor, *secrets):
    """``fn(x, gidx, *secrets)``; for a DTensor microbatch, on this rank's
    own groups (``to_local()``: no DTensor reaches a kernel) with the
    replicated secret stacks, the result placed as ``x``."""
    if not is_dtensor(x):
        return fn(x, gidx, *secrets)
    from torch.distributed.tensor import DTensor

    out = fn(x.to_local(), gidx.to_local(), *secrets)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)


def _delivery_step(x: torch.Tensor, gidx: torch.Tensor, cores: torch.Tensor,
                   augs: torch.Tensor, kappa: int) -> torch.Tensor:
    """morph + Aug-Conv forward for one padded microbatch: two grouped
    kernel launches on the card (their plain versions on the CPU).

    x: (G, B, F_in); gidx: (G,); cores: (S, q, q); augs: (S, F_in, F_out).
    One path for every ``gidx``: both kernels read each group's secrets in
    place from the stacked slot tensors.  The group axis is the natural
    data-parallel axis (``delivery_rules``): DTensor ``x`` and ``gidx`` run
    on each rank's own groups.
    """
    morphed = _on_local_groups(morph_rows_grouped, x, gidx, cores, kappa)
    return _on_local_groups(aug_conv_forward_grouped, morphed, gidx, augs)


def _lm_delivery_step(tokens: torch.Tensor, gidx: torch.Tensor,
                      perms: torch.Tensor,
                      aug_embeds: torch.Tensor | None):
    """Token morph (+ optional Aug-Embedding) for one padded microbatch.

    tokens: (G, B, L) int32; gidx: (G,); perms: (S, V) int32; aug_embeds:
    (S, V, d), or None when no request of the microbatch asked for features.
    Returns (morphed, feats) with feats None without ``aug_embeds``.  Both
    are gathers through each group's slot of the stacks, for any ``gidx``.
    """
    morphed = _on_local_groups(token_morph_grouped, tokens, gidx, perms)
    if aug_embeds is None:
        return morphed, None
    return morphed, _on_local_groups(aug_embed_grouped, morphed, gidx,
                                     aug_embeds)
