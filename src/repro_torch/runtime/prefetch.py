"""Per-tenant arrival prediction for slot prefetch.

The registry's LRU slot table evicts tenants that go quiet; their first
request after an idle spell then pays the activation cost (host -> device
secret upload, plan patch) inline on the serving path.  Most real tenants
are *periodic* — training jobs poll on a timer, inference fleets tick in
lockstep — so the engine can stage an evicted tenant's slot **before** the
burst lands.

:class:`ArrivalPredictor` keeps a tiny per-tenant arrival history (EWMA of
inter-arrival gaps plus a simple periodicity detector) and answers one
question: *which known tenants are due within the next horizon?*  The
engine feeds every front-door submission through :meth:`observe` and calls
:meth:`due` from ``predictive_prefetch``; hits and misses are scored by the
engine (a predicted tenant that submits while resident is a hit), so the
predictor stays pure arithmetic with no registry knowledge.

Estimation is deliberately simple, per the ROADMAP's carry-over (a):

* the **EWMA** of inter-arrival gaps tracks drifting request rates with a
  couple of samples of memory;
* the **periodicity** check looks at the last ``history`` gaps — when
  their coefficient of variation is below ``periodic_cv`` the tenant is
  ticking a clock, and the *median* gap (robust to one hiccup) beats the
  EWMA (which an outlier gap would drag for several arrivals).

All times are caller-supplied seconds (the engine injects its clock), so
tests and benchmarks drive the predictor with synthetic time.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics

__all__ = ["ArrivalPredictor"]


@dataclasses.dataclass
class _TenantHistory:
    last: float                      # most recent arrival (seconds)
    ewma: float | None = None        # smoothed inter-arrival gap
    gaps: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=8)
    )


class ArrivalPredictor:
    """EWMA + periodicity estimator over per-tenant arrival times.

    ``alpha`` is the EWMA smoothing factor on inter-arrival gaps,
    ``periodic_cv`` the coefficient-of-variation threshold under which a
    tenant counts as periodic, ``history`` the gap-window length, and
    ``max_tenants`` bounds memory: when exceeded, the tenant with the
    stalest last-arrival is dropped (it has the least predictive value).
    """

    def __init__(
        self,
        *,
        alpha: float = 0.3,
        periodic_cv: float = 0.25,
        history: int = 8,
        max_tenants: int = 4096,
    ):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if history < 2:
            raise ValueError(f"history must be >= 2, got {history}")
        self.alpha = float(alpha)
        self.periodic_cv = float(periodic_cv)
        self.history = int(history)
        self.max_tenants = int(max_tenants)
        self._tenants: dict[str, _TenantHistory] = {}

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def observe(self, tenant_id: str, now: float) -> None:
        """Record one arrival at time ``now`` (seconds, any monotone base)."""
        h = self._tenants.get(tenant_id)
        if h is None:
            if len(self._tenants) >= self.max_tenants:
                stalest = min(self._tenants, key=lambda t: self._tenants[t].last)
                del self._tenants[stalest]
            h = self._tenants[tenant_id] = _TenantHistory(last=float(now))
            h.gaps = collections.deque(maxlen=self.history)
            return
        gap = float(now) - h.last
        h.last = float(now)
        if gap <= 0:
            # Same-instant burst members carry no inter-arrival information.
            return
        h.ewma = gap if h.ewma is None else (
            self.alpha * gap + (1 - self.alpha) * h.ewma
        )
        h.gaps.append(gap)

    def interval(self, tenant_id: str) -> float | None:
        """Expected inter-arrival gap, or None with < 2 spaced arrivals.

        Periodic tenants (>= 4 recorded gaps with coefficient of variation
        <= ``periodic_cv``) report the median gap; otherwise the EWMA.
        """
        h = self._tenants.get(tenant_id)
        if h is None or h.ewma is None:
            return None
        if len(h.gaps) >= 4:
            mean = statistics.fmean(h.gaps)
            cv = statistics.pstdev(h.gaps) / mean if mean > 0 else float("inf")
            if cv <= self.periodic_cv:
                return statistics.median(h.gaps)
        return h.ewma

    def predicted_next(self, tenant_id: str) -> float | None:
        """Predicted time of the tenant's next arrival, or None."""
        iv = self.interval(tenant_id)
        if iv is None:
            return None
        return self._tenants[tenant_id].last + iv

    def due(self, horizon_s: float, now: float) -> list[str]:
        """Tenants predicted to arrive within ``now + horizon_s``, soonest
        first.  Tenants more than one interval overdue are excluded — a
        stopped tenant should not be re-staged forever on stale history."""
        out: list[tuple[float, str]] = []
        for t, h in self._tenants.items():
            iv = self.interval(t)
            if iv is None:
                continue
            nxt = h.last + iv
            if nxt <= now + horizon_s and now <= nxt + iv:
                out.append((nxt, t))
        out.sort()
        return [t for _, t in out]
