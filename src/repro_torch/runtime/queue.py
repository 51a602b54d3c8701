"""Weighted-fair request queues + padded-microbatch coalescing.

Copied from ``repro.runtime.queue`` (the port may not import the JAX
package): :class:`FairScheduler`, :class:`RequestQueue`, :class:`Microbatch`
and :class:`QueuedRequest` are the reference's code, so the port coalesces
the same microbatches from the same traffic.  ``TokenQueue`` and
``FairAdmissionQueue`` (the LM lanes) arrive with a later slice.

Requests arrive as (tenant, rows) with a per-request priority; tenants are
many, batches are small.  The coalescer packs pending rows into a *padded
microbatch*:

  * rows are grouped by tenant (a tenant's pending rows are chopped into
    chunks of at most ``max_rows``);
  * every chunk becomes one *group* of the microbatch tensor ``(G, B, F)``;
  * ``B`` is the smallest bucket that fits the largest chunk and ``G`` is
    bucket-rounded too, so the jitted engine path compiles once per
    ``(G, B)`` bucket pair instead of once per traffic pattern;
  * groups are **slot-sorted**: chunks are ordered by their registry slot
    index (stable, so a tenant's overflow chunks stay adjacent) — the
    engine's grouped kernels see monotone slot indices and the steady-state
    full-table microbatch degenerates to ``gidx == arange(S)`` for free;
  * padding rows are zeros and padding *groups* carry their own group index
    clamped to the slot-table bound — clamps are counted on the microbatch
    (``n_clamped_padding``) so the engine can surface them in its stats.

**Scheduling** is weighted fair queueing (start-time fair queueing flavour),
and the WFQ core lives in one place: :class:`FairScheduler`.

  * each tenant carries a *virtual time* that advances by
    ``service_units / weight`` whenever one of its chunks is scheduled; a
    queue always serves the backlogged tenant with the smallest virtual
    time, so under saturation a weight-2 tenant receives ~2x the service of
    a weight-1 tenant regardless of arrival interleaving;
  * a tenant going idle keeps its virtual time but re-enters at
    ``max(own, global)`` when it becomes backlogged again — idling banks no
    credit; idle records whose debt the global clock has caught up with are
    pruned (re-entry resolves identically), records still carrying debt
    survive the prune;
  * **within** a tenant, requests dequeue by priority (higher first), FIFO
    within a priority level; only the head request of a lane may be
    partially scheduled, and a request's own rows always flow in order.

**One clock per engine, not per lane.**  A ``FairScheduler`` can be shared:
the delivery engine injects one instance into its vision ``RequestQueue``,
every per-seq-bucket queue inside ``TokenQueue``, the continuous-features
``RequestQueue``, and the decode lane's ``FairAdmissionQueue``.  All of them
charge *service units* — rows, rows, rows, and decode steps x a configurable
exchange rate (``decode_step_units``) — against the same per-tenant records
and one global virtual clock, so a tenant's weight is a true whole-engine
share: splitting traffic across lanes buys nothing (previously each lane ran
an independent clock, inflating a multi-lane tenant's share by up to the
number of lanes it touched).  A stand-alone queue builds a private scheduler
and behaves exactly as before.

The queues are deliberately synchronous and **not thread-safe** (``submit`` /
``coalesce``); the reference's async front door
(``repro.runtime.async_engine``) serializes access behind its lock and
layers deadline-driven flushing and admission control on top.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Callable, Iterable, Mapping

import numpy as np

__all__ = [
    "FairScheduler",
    "GroupSlice",
    "Microbatch",
    "QueuedRequest",
    "RequestQueue",
]


def bucketize(n: int, buckets: Iterable[int]) -> int:
    """Smallest bucket >= n (buckets assumed sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket in {tuple(buckets)}")


@dataclasses.dataclass
class QueuedRequest:
    """One tenant's pending ask: morph-and-deliver ``rows`` (b, F)."""

    request_id: int
    tenant_id: str
    rows: np.ndarray            # (b, F) unrolled private data
    priority: int = 0           # within-tenant: higher dequeues first
    seq: int = 0                # arrival order (FIFO within a priority)
    delivered: int = 0          # rows already scheduled into microbatches


@dataclasses.dataclass(frozen=True)
class GroupSlice:
    """Where a contiguous run of one request's rows landed in a microbatch."""

    request_id: int
    req_offset: int             # first row of the run within the request
    group: int                  # group index in the microbatch
    group_offset: int           # first row of the run within the group
    n_rows: int


@dataclasses.dataclass
class Microbatch:
    """A padded (G, B, F) tensor plus the bookkeeping to scatter results back."""

    x: np.ndarray               # (G, B, F) zero-padded rows
    group_tenant: np.ndarray    # (G,) int32 slot index per group; real
    # groups sorted ascending, padding groups carry their own (clamped)
    # index — identify them via n_real_groups
    slices: list[GroupSlice]
    n_real_groups: int
    n_real_rows: int
    n_clamped_padding: int = 0  # padding groups whose index hit the clamp

    @property
    def n_padded_rows(self) -> int:
        return self.x.shape[0] * self.x.shape[1] - self.n_real_rows


@dataclasses.dataclass
class _TenantLane:
    """One tenant's engine-wide WFQ record: virtual time + share.

    ``backlogged`` is a reference count of the queues currently holding a
    non-empty backlog for this tenant — the record is "live" while any lane
    does, and the idle re-entry rule fires only on the 0 -> 1 transition
    (a tenant already active on another lane is not "waking from idle").
    """

    tenant_id: str
    vtime: float = 0.0
    weight: float = 1.0
    backlogged: int = 0


class FairScheduler:
    """The WFQ core: one virtual clock + per-tenant records, shareable
    across every lane of a delivery engine.

    Queues own their request backlogs; the scheduler owns the fairness
    state.  The serving protocol per scheduled chunk is::

        rec = sched.peek(tenant)       # picked as the queue's min-vtime
        sched.advance_clock()          # vnow := min backlogged vtime
        ... dequeue the chunk; sched.exit_backlog(t) if it drained ...
        sched.charge(rec, units, lane) # vtime += units / weight

    ``advance_clock`` runs *before* the charge, while the picked tenant
    still counts as backlogged: the global clock tracks the minimum virtual
    time over every backlogged tenant **engine-wide**, so a tenant waking
    from idle re-enters at the true service frontier even when the lane it
    wakes on is ahead of another lane's backlog.  For a single stand-alone
    queue this reduces exactly to the classic ``vnow = max(vnow, picked
    lane's vtime)`` rule.

    Weights resolve in one place: an optional ``weight_of`` callable (the
    engine passes its registry lookup) is re-applied on every
    :meth:`lane` call, so registry weight changes take effect without
    draining any queue; without a resolver, explicit per-submit weights
    persist in ``_weights`` across idle spells and the record prune.

    ``decode_step_units`` is the decode-lane exchange rate: the service
    units one owed decode step charges, relative to one morph-lane row
    (:class:`FairAdmissionQueue` multiplies ``max_new_tokens`` by it).
    """

    def __init__(
        self,
        weight_of: Callable[[str], float] | None = None,
        *,
        decode_step_units: float = 1.0,
    ):
        if not decode_step_units > 0:
            raise ValueError(
                f"decode_step_units must be positive, got {decode_step_units}"
            )
        self._weight_of = weight_of
        self.decode_step_units = float(decode_step_units)
        self._tenants: dict[str, _TenantLane] = {}
        self._vnow = 0.0
        # Explicit (non-default) WFQ shares; survives record pruning so a
        # weight set at submit time persists across a tenant's idle spells.
        # Unused (shadowed) while a weight_of resolver is installed.
        self._weights: dict[str, float] = {}
        # Lazy min-heap of (vtime, tenant) over backlogged tenants:
        # min_backlogged_vtime() is an amortized O(log n) peek instead of an
        # O(tenants) scan per served chunk.  vtimes only ever increase, so a
        # stale entry (tenant idle, pruned, or since charged) is detected by
        # key mismatch and dropped/re-keyed on pop.
        self._heap: list[tuple[float, str]] = []
        # Cumulative service units, for the engine's share accounting.
        self.service_by_lane: collections.Counter = collections.Counter()
        self.service_by_tenant: collections.Counter = collections.Counter()

    @property
    def vnow(self) -> float:
        """The global virtual clock."""
        return self._vnow

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    # -- weights --------------------------------------------------------------
    def _resolve_weight(self, rec: _TenantLane) -> None:
        if self._weight_of is not None:
            rec.weight = float(self._weight_of(rec.tenant_id))
        else:
            rec.weight = self._weights.get(rec.tenant_id, 1.0)

    def set_weight(self, tenant_id: str, weight: float) -> None:
        """Set a tenant's explicit share (stand-alone queues; the engine
        resolves weights through ``weight_of`` instead)."""
        w = float(weight)
        if not w > 0:
            raise ValueError(f"weight must be positive, got {weight}")
        if w != 1.0:
            self._weights[tenant_id] = w
        else:
            self._weights.pop(tenant_id, None)
        rec = self._tenants.get(tenant_id)
        if rec is not None and self._weight_of is None:
            rec.weight = w

    # -- records --------------------------------------------------------------
    def lane(self, tenant_id: str) -> _TenantLane:
        """Get-or-create a tenant's record, re-resolving its weight (so a
        registry weight change reaches the scheduler on the next submit)."""
        rec = self._tenants.get(tenant_id)
        if rec is None:
            rec = self._tenants[tenant_id] = _TenantLane(
                tenant_id, vtime=self._vnow
            )
        self._resolve_weight(rec)
        return rec

    def peek(self, tenant_id: str) -> _TenantLane:
        """A tenant's existing record (KeyError when absent/pruned)."""
        return self._tenants[tenant_id]

    def enter_backlog(self, tenant_id: str) -> _TenantLane:
        """A queue gained a backlog for this tenant.  On the idle ->
        backlogged transition the record re-enters at the global clock —
        idling banks no credit."""
        rec = self.lane(tenant_id)
        if rec.backlogged == 0:
            rec.vtime = max(rec.vtime, self._vnow)
        rec.backlogged += 1
        heapq.heappush(self._heap, (rec.vtime, tenant_id))
        return rec

    def exit_backlog(self, tenant_id: str) -> None:
        """A queue's backlog for this tenant drained."""
        rec = self._tenants[tenant_id]
        rec.backlogged -= 1
        assert rec.backlogged >= 0, (tenant_id, rec.backlogged)

    # -- the clock ------------------------------------------------------------
    def min_backlogged_vtime(self) -> float | None:
        """Smallest virtual time over all backlogged tenants engine-wide
        (None when nothing is backlogged anywhere)."""
        heap = self._heap
        while heap:
            vt, t = heap[0]
            rec = self._tenants.get(t)
            if rec is not None and rec.backlogged and rec.vtime == vt:
                return vt
            heapq.heappop(heap)
            if rec is not None and rec.backlogged and rec.vtime > vt:
                heapq.heappush(heap, (rec.vtime, t))   # re-key stale entry
        return None

    def advance_clock(self) -> None:
        """Advance the global clock to the service frontier — call right
        before charging a picked tenant, while it still counts backlogged."""
        m = self.min_backlogged_vtime()
        if m is not None and m > self._vnow:
            self._vnow = m

    def charge(self, rec: _TenantLane, units: float, lane: str = "") -> None:
        """Bill ``units`` of service against a tenant's virtual time."""
        rec.vtime += units / rec.weight
        if rec.backlogged:
            heapq.heappush(self._heap, (rec.vtime, rec.tenant_id))
        self.service_by_lane[lane] += units
        self.service_by_tenant[rec.tenant_id] += units

    def prune(self) -> None:
        """Drop idle records the global clock has caught up with: re-entry
        at ``max(own, global)`` would resolve to ``global`` anyway, so the
        drop is semantically invisible — explicit weights live in
        ``_weights`` and survive — and it bounds the record map by the set
        of *recently* active tenants instead of every tenant ever seen.
        Idle records still carrying debt (vtime > global) survive until
        served traffic advances the clock past them."""
        if any(
            not rec.backlogged and rec.vtime <= self._vnow
            for rec in self._tenants.values()
        ):
            self._tenants = {
                t: rec for t, rec in self._tenants.items()
                if rec.backlogged or rec.vtime > self._vnow
            }

    # -- observability --------------------------------------------------------
    def wfq_lag(self) -> float:
        """Virtual-time spread (max - min) across backlogged tenants
        engine-wide: how far the scheduler is from perfectly proportional
        service right now (0 with fewer than two backlogged tenants)."""
        vts = [r.vtime for r in self._tenants.values() if r.backlogged]
        return max(vts) - min(vts) if len(vts) > 1 else 0.0

    def service_share(self) -> dict[str, float]:
        """Fraction of all service units charged, per lane name (empty
        before any service)."""
        total = sum(self.service_by_lane.values())
        if not total:
            return {}
        return {k: v / total for k, v in self.service_by_lane.items()}

    # -- crash safety ---------------------------------------------------------
    def snapshot_state(self) -> dict:
        """JSON-able image of the fairness state.  Backlog refcounts are
        deliberately absent: restore happens on drained queues, and the
        engine's request replay re-enters every backlog through submit."""
        return {
            "vnow": self._vnow,
            "tenants": {
                t: {"vtime": r.vtime, "weight": r.weight}
                for t, r in self._tenants.items()
            },
            "weights": dict(self._weights),
            "service_by_lane": dict(self.service_by_lane),
            "service_by_tenant": dict(self.service_by_tenant),
        }

    def restore_state(self, state: dict) -> None:
        """Rebuild from :meth:`snapshot_state`.  Every record comes back
        idle (backlogged == 0) with its virtual time intact — backlogged
        records always satisfy ``vtime >= vnow``, so the replaying submits'
        idle re-entry ``max(own, vnow)`` is a no-op and the restored engine
        resumes with the exact pre-crash fairness positions."""
        self._vnow = float(state["vnow"])
        self._weights = {
            t: float(w) for t, w in state.get("weights", {}).items()
        }
        self._tenants = {
            t: _TenantLane(
                t, vtime=float(d["vtime"]), weight=float(d["weight"])
            )
            for t, d in state.get("tenants", {}).items()
        }
        self._heap = []
        self.service_by_lane = collections.Counter(
            state.get("service_by_lane", {})
        )
        self.service_by_tenant = collections.Counter(
            state.get("service_by_tenant", {})
        )


def _pick_backlogged(
    pick_heap: list[tuple[float, int, str]],
    backlogs: Mapping[str, list],
    scheduler: FairScheduler,
) -> str | None:
    """Backlogged tenant with the smallest ``(vtime, head arrival seq)`` —
    a lazy heap replacing the old O(tenants) scan.  Entries go stale when
    the tenant drained from this queue, was charged (possibly by *another*
    lane sharing the scheduler), or its head request changed (a
    higher-priority submit); stale entries are dropped or re-keyed on pop,
    so the returned minimum is always over current keys — the exact
    deterministic tie-break the linear scan computed."""
    while pick_heap:
        vt, seq, tenant = pick_heap[0]
        blog = backlogs.get(tenant)
        if not blog:
            heapq.heappop(pick_heap)
            continue
        key = (scheduler.peek(tenant).vtime, blog[0][1])
        if (vt, seq) != key:
            heapq.heappop(pick_heap)
            heapq.heappush(pick_heap, (key[0], key[1], tenant))
            continue
        return tenant
    return None


class RequestQueue:
    """Weighted-fair delivery queue with tenant-grouped, bucket-padded
    coalescing (priority-then-FIFO within a tenant, WFQ across tenants).

    Fairness state lives in a :class:`FairScheduler` — pass the engine's
    shared instance so this lane charges the same per-tenant clock as every
    other lane; omit it for a private clock (stand-alone use).
    """

    def __init__(
        self,
        feature_dim: int,
        *,
        max_rows: int = 64,
        row_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
        group_buckets: tuple[int, ...] = (1, 2, 4, 8, 16),
        dtype=np.float32,
        id_alloc: Callable[[], int] | None = None,
        scheduler: FairScheduler | None = None,
        service_lane: str = "rows",
    ):
        assert max_rows in row_buckets, (max_rows, row_buckets)
        self.feature_dim = feature_dim
        self.max_rows = max_rows
        self.row_buckets = tuple(sorted(row_buckets))
        self.group_buckets = tuple(sorted(group_buckets))
        self.dtype = np.dtype(dtype)
        self.scheduler = scheduler if scheduler is not None else FairScheduler()
        self.service_lane = service_lane
        # The engine passes one shared allocator to all of its lanes so a
        # request id is unique engine-wide (take() is lane-agnostic); a
        # stand-alone queue falls back to its own counter.
        self._id_alloc = id_alloc
        self._next_id = 0
        self._seq = itertools.count()
        # tenant -> min-heap of (-priority, seq, request): the head is the
        # next request to dequeue (highest priority, FIFO within a level).
        # Only non-empty heaps are kept; each keyed tenant holds exactly one
        # scheduler backlog reference.
        self._backlogs: dict[str, list] = {}
        # Lazy (vtime, head_seq, tenant) pick heap — see _pick_backlogged.
        self._pick: list[tuple[float, int, str]] = []
        self._live: dict[int, QueuedRequest] = {}   # rid -> pending request
        # Lazy min-heap over live rids: oldest_pending_id is an amortized
        # O(log n) peek instead of an O(n) min-scan (TokenQueue reads it per
        # bucket per coalesce).  Entries whose rid left _live are stale.
        self._id_heap: list[int] = []
        self._pending_rows = 0                      # running unscheduled rows

    def __len__(self) -> int:
        return len(self._live)

    # Legacy spellings, delegating to the scheduler (tests and embedders
    # predating the shared-clock refactor read these).
    @property
    def _vnow(self) -> float:
        return self.scheduler.vnow

    @property
    def _lanes(self) -> dict[str, _TenantLane]:
        return self.scheduler._tenants

    @property
    def _weights(self) -> dict[str, float]:
        return self.scheduler._weights

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    @property
    def oldest_pending_id(self) -> int | None:
        """Smallest pending request id — ids are allocated monotonically, so
        this is the oldest arrival (None when empty)."""
        heap = self._id_heap
        while heap and heap[0] not in self._live:
            heapq.heappop(heap)
        return heap[0] if heap else None

    def pending_rows_by_tenant(self) -> dict[str, int]:
        """Unscheduled row counts keyed by tenant (observability/debugging)."""
        out: dict[str, int] = {}
        for r in self._live.values():
            left = r.rows.shape[0] - r.delivered
            if left:
                out[r.tenant_id] = out.get(r.tenant_id, 0) + left
        return out

    def wfq_lag(self) -> float:
        """Virtual-time spread across backlogged tenants — engine-wide when
        the scheduler is shared (see :meth:`FairScheduler.wfq_lag`)."""
        return self.scheduler.wfq_lag()

    def ensure_group_bucket(self, n: int) -> None:
        """Add ``n`` to the group buckets (steady-state "all tenants active"
        microbatches then land exactly on G == n).  Counts above the largest
        bucket are ignored: max_groups stays the configured ceiling and such
        traffic simply spans several microbatches."""
        if 0 < n <= self.group_buckets[-1]:
            self.group_buckets = tuple(sorted({*self.group_buckets, n}))

    def release(self) -> None:
        """Drop every pending request and hand the backlog references back
        to the scheduler.  Crash recovery replaces a (possibly half-
        coalesced) queue and replays its requests from the engine's retained
        payloads; without the release a shared scheduler would keep counting
        the dead queue's backlogs as live and hold the clock back forever."""
        for tenant in self._backlogs:
            self.scheduler.exit_backlog(tenant)
        self._backlogs.clear()
        self._pick.clear()
        self._live.clear()
        self._id_heap.clear()
        self._pending_rows = 0

    def submit(
        self,
        tenant_id: str,
        rows: np.ndarray,
        *,
        priority: int = 0,
        weight: float | None = None,
        rid: int | None = None,
    ) -> int:
        """Enqueue ``rows`` for ``tenant_id``.

        ``priority`` orders this request within its tenant (higher first,
        FIFO within a level); ``weight`` sets the tenant's WFQ share on the
        scheduler — it persists across the tenant's idle spells (and the
        idle-record prune) until overwritten (engines resolve weights
        through the scheduler's ``weight_of`` instead, so registry weight
        changes take effect without draining the queue).  ``rid`` overrides
        id allocation — crash-recovery replay re-enqueues a request under
        its original id so no in-flight id is lost or duplicated across a
        restore.
        """
        rows = np.asarray(rows, self.dtype)
        if rows.ndim != 2 or rows.shape[1] != self.feature_dim:
            raise ValueError(
                f"expected rows of shape (b, {self.feature_dim}), got {rows.shape}"
            )
        if rows.shape[0] == 0:
            # A zero-row request would coalesce into a phantom "real" group
            # (largest=0 -> bucket 1) of pure padding; api.normalize rejects
            # these at the front door, this guards stand-alone queue users.
            raise ValueError(
                f"empty submission for tenant {tenant_id!r}: rows must "
                f"contain at least one row"
            )
        if rid is not None:
            rid = int(rid)
            self._next_id = max(self._next_id, rid + 1)
        elif self._id_alloc is not None:
            rid = self._id_alloc()
        else:
            rid = self._next_id
            self._next_id += 1
        if weight is not None:
            self.scheduler.set_weight(tenant_id, weight)   # validates > 0
        blog = self._backlogs.get(tenant_id)
        if blog is None:
            blog = self._backlogs[tenant_id] = []
        rec = (
            self.scheduler.enter_backlog(tenant_id) if not blog
            else self.scheduler.lane(tenant_id)
        )
        req = QueuedRequest(
            rid, tenant_id, rows, priority=int(priority), seq=next(self._seq)
        )
        heapq.heappush(blog, (-req.priority, req.seq, req))
        heapq.heappush(self._pick, (rec.vtime, blog[0][1], tenant_id))
        self._live[rid] = req
        heapq.heappush(self._id_heap, rid)
        self._pending_rows += rows.shape[0]
        return rid

    # -- WFQ chunk selection -------------------------------------------------
    def _pick_lane(self) -> str | None:
        """Backlogged tenant with the smallest (vtime, head arrival seq)."""
        return _pick_backlogged(self._pick, self._backlogs, self.scheduler)

    def _take_chunk(
        self, tenant_id: str
    ) -> tuple[list[tuple[QueuedRequest, int, int]], int]:
        """Dequeue up to ``max_rows`` rows from the tenant's backlog in
        priority-then-FIFO order, committing ``delivered`` offsets; returns
        (runs, n_rows).  Releases the scheduler backlog ref on drain."""
        blog = self._backlogs[tenant_id]
        runs: list[tuple[QueuedRequest, int, int]] = []
        used = 0
        while blog and used < self.max_rows:
            req = blog[0][2]
            remaining = req.rows.shape[0] - req.delivered
            take = min(remaining, self.max_rows - used)
            runs.append((req, req.delivered, take))
            req.delivered += take
            used += take
            if req.delivered == req.rows.shape[0]:
                heapq.heappop(blog)
                del self._live[req.request_id]
        if not blog:
            del self._backlogs[tenant_id]
            self.scheduler.exit_backlog(tenant_id)
        self._pending_rows -= used
        return runs, used

    def coalesce(
        self,
        tenant_index: Mapping[str, int] | Callable[[str], int],
        max_groups: int | None = None,
    ) -> Microbatch | None:
        """Pack pending rows into one padded microbatch, WFQ-fairly.

        ``tenant_index`` maps tenant id -> slot index into the registry's
        stacked secret arrays (a callable lookup may activate the tenant as a
        side effect — see ``SessionRegistry.slot_for``).  ``max_groups`` caps
        the number of groups below the largest group bucket — the engine
        passes its registry capacity so one microbatch never asks for more
        resident tenants than there are slots.  Returns None when the queue
        is empty.

        Group selection order is the WFQ order: repeatedly serve one
        ``max_rows``-chunk from the backlogged tenant with the smallest
        virtual time, charging ``rows / weight`` on the (possibly shared)
        scheduler — so a saturated microbatch splits its groups across
        tenants in proportion to their engine-wide weights.
        """
        if not self._live:
            return None
        lookup = tenant_index if callable(tenant_index) else tenant_index.__getitem__

        max_groups = min(
            self.group_buckets[-1],
            max_groups if max_groups is not None else self.group_buckets[-1],
        )
        sched = self.scheduler
        chunks: list[tuple[str, list[tuple[QueuedRequest, int, int]]]] = []
        while len(chunks) < max_groups:
            tenant = self._pick_lane()
            if tenant is None:
                break
            rec = sched.peek(tenant)
            # The served chunk's start tag is the global virtual time: lanes
            # waking from idle resume here instead of at 0.  Advanced while
            # the picked tenant is still backlogged, over every lane sharing
            # the scheduler.
            sched.advance_clock()
            runs, n = self._take_chunk(tenant)
            sched.charge(rec, n, self.service_lane)
            chunks.append((tenant, runs))

        sched.prune()

        if not chunks:
            return None

        # Slot-sorted coalescing: order groups by their registry slot so the
        # grouped kernels see monotone indices (adjacent groups sharing a
        # slot reuse the resident secret tile, and the full-table microbatch
        # degenerates to gidx == arange).  Slot lookups happen once per
        # tenant, in WFQ service order, *before* sorting — slot_for may
        # activate an evicted tenant, and that must follow the order the
        # scheduler actually granted service in.
        slot_of: dict[str, int] = {}
        for tenant, _ in chunks:
            if tenant not in slot_of:
                slot_of[tenant] = lookup(tenant)
        chunks.sort(key=lambda c: slot_of[c[0]])  # stable: WFQ order in a slot

        largest = max(sum(n for _, _, n in runs) for _, runs in chunks)
        B = bucketize(largest, self.row_buckets)
        G = bucketize(len(chunks), self.group_buckets)

        x = np.zeros((G, B, self.feature_dim), self.dtype)
        gidx = np.empty(G, dtype=np.int32)
        slices: list[GroupSlice] = []
        n_real_rows = 0
        for g, (tenant, runs) in enumerate(chunks):
            gidx[g] = slot_of[tenant]
            cursor = 0
            for req, off, n in runs:
                x[g, cursor : cursor + n] = req.rows[off : off + n]
                slices.append(GroupSlice(req.request_id, off, g, cursor, n))
                cursor += n
                n_real_rows += n
        # Padding groups carry their own group index, clamped to the slot
        # table bound (max_groups == registry capacity in engine use):
        # all-zero rows make their output zeros regardless of whose secrets
        # they hit, and a dense prefix of active slots plus padding
        # degenerates to gidx == arange — the in-place fast case on the jnp
        # backend (the grouped kernels cost the same either way).  Clamps
        # are counted so the engine can surface them (padding_clamp_count):
        # a clamped group reads a real tenant's secrets with zero rows —
        # harmless, but a sparse-table CPU serving regression worth seeing.
        pad = np.arange(len(chunks), G, dtype=np.int32)
        gidx[len(chunks):] = np.minimum(pad, max_groups - 1)
        n_clamped = int(np.count_nonzero(pad > max_groups - 1))

        return Microbatch(
            x=x, group_tenant=gidx, slices=slices,
            n_real_groups=len(chunks), n_real_rows=n_real_rows,
            n_clamped_padding=n_clamped,
        )
