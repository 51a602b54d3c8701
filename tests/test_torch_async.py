"""The port's async front door (``repro_torch.runtime.async_engine``) on the
CPU, beside the reference's (``repro.runtime.async_engine``).

Both packages get the same tenants (a reference ``SessionRegistry``
snapshotted into the port's, so the secrets are byte-equal).  The port's
front door is held to what ``tests/test_async_engine.py``,
``tests/test_engine_resilience.py`` and the async cases of
``tests/test_delivery_api.py`` ask of the reference's: concurrent
submitters lose and duplicate no request id, deadlines and full buckets
fire the flusher, admission blocks or rejects per tenant, cancel/drain/close
keep their contracts, the supervised flusher recovers from a
``SimulatedFailure`` at each phase exactly once, and snapshots restore
through ``snapshot_dir``.  Results are held within 1e-5 of per-request
delivery and of the reference's front door on the same requests, and a
snapshot directory written by either package's front door restores in the
other's.

Two properties are the port's own.  A flush whose device step is held
mid-way keeps the secrets its ``gidx`` was built against while a prefetch
registers and evicts tenants (the engine's pins).  And an error from the
device phase that is not a ``SimulatedFailure`` (a kernel's CUDA error)
marks the front door dead instead of failing one round and carrying on.

Timing: the tests assert order, counts and exactly-once delivery, waiting
on events; the few wall-clock bounds that remain are looser than the
reference's.  Latency is measured on the card (``chip_smoke.py``).
"""
import sys
import threading
import time
from concurrent import futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.runtime as jrt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    AdmissionError, AsyncDeliveryEngine, DeliveryRequest, EngineDeadError,
    FailureInjector, MoLeDeliveryEngine,
)

from _hypothesis_compat import given, settings, st  # noqa: E402

SHAPE = (2, 4, 6, 3)            # alpha, beta, m, p
GEOM = tcore.ConvGeometry(*SHAPE)
ATOL = 1e-5
FLUSH_PHASES = ("coalesce", "device", "publish")
# A flush that must come from the deadline flusher alone: generous slack
# over the SLO for a loaded machine (the reference allows 750 ms).
SLACK_MS = 5_000.0


def _registries(seed=0, tenants=3, kappa=2, capacity=None):
    rng = np.random.default_rng(seed)
    jg = jcore.ConvGeometry(*SHAPE)
    jreg = jcore.SessionRegistry(jg, kappa=kappa, capacity=capacity)
    for i in range(tenants):
        k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(
            np.float32) / np.sqrt(jg.alpha * jg.p * jg.p)
        jreg.register(f"t{i}", k, seed=100 + seed + i)
    treg = tcore.SessionRegistry(GEOM, kappa=kappa, capacity=capacity)
    treg.restore_state(*jreg.snapshot_state())
    return jreg, treg


def _registry(**kw):
    return _registries(**kw)[1]


def _rq(tenant, data, **kw):
    return DeliveryRequest(tenant, data, **kw)


def _data(rng, b=1):
    return rng.standard_normal((b, GEOM.alpha, GEOM.m, GEOM.m)).astype(
        np.float32
    )


def _want(reg, tenant, data):
    return reg.session(tenant).deliver(torch.from_numpy(data)).numpy()


def _front(reg, **kw):
    return AsyncDeliveryEngine(reg, device="cpu", **kw)


class _HeldExecuteEngine(MoLeDeliveryEngine):
    """Engine whose device step blocks on its first work item until
    released — makes 'the flush's device step is in flight' a deterministic
    window instead of a race."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.in_device = threading.Event()
        self.release = threading.Event()
        self.works = []

    def execute_flush(self, work):
        self.works.append(work)
        return super().execute_flush(work)

    def _execute(self, x, gidx, plan):
        if not self.in_device.is_set():
            self.in_device.set()
            assert self.release.wait(timeout=60), "test never released"
        return super()._execute(x, gidx, plan)


# ---------------------------------------------------------------------------
# results: per-request delivery and the reference's front door
# ---------------------------------------------------------------------------

def test_concurrent_load_matches_sync_and_reference_front():
    """6 threads x 3 tenants: no lost/duplicated request ids, and every
    result is per-request delivery's and the reference front door's on the
    same requests, within 1e-5."""
    rng = np.random.default_rng(0)
    jreg, treg = _registries(tenants=3)
    datas = {t: _data(rng, 1 + i % 3) for i, t in enumerate(treg.tenant_ids)}
    n_threads, per_thread = 6, 8
    plan = [[f"t{(w + j) % 3}" for j in range(per_thread)]
            for w in range(n_threads)]

    def run(front, Request):
        futs = [[] for _ in range(n_threads)]
        errors = []

        def worker(wid):
            try:
                for t in plan[wid]:
                    futs[wid].append((t, front.submit(Request(t, datas[t]))))
            except BaseException as e:  # pragma: no cover - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errors and not any(th.is_alive() for th in threads)
        flat = [tf for per in futs for tf in per]
        rids = [f.request_id for _, f in flat]
        assert len(set(rids)) == len(rids) == n_threads * per_thread
        return {(w, j): flat[w * per_thread + j][1].result(timeout=60).payload
                for w in range(n_threads) for j in range(per_thread)}

    with _front(treg, max_delay_ms=5.0) as front:
        got = run(front, DeliveryRequest)
    assert front.pending() == 0
    assert front.stats.requests == n_threads * per_thread
    with jrt.AsyncDeliveryEngine(jrt.MoLeDeliveryEngine(jreg, backend="jnp"),
                                 max_delay_ms=5.0) as jfront:
        ref = run(jfront, jrt.DeliveryRequest)
    for (w, j), out in got.items():
        t = plan[w][j]
        np.testing.assert_allclose(out, _want(treg, t, datas[t]), atol=ATOL)
        np.testing.assert_allclose(out, np.asarray(ref[(w, j)]), atol=ATOL)


def test_mixed_fleet_vision_and_lm_concurrent():
    """Vision and LM token requests through one front door from 6 threads:
    one id space across lanes, none lost or duplicated; images equal
    per-request delivery and tokens the reference session's morph."""
    rng = np.random.default_rng(1)
    _, vreg = _registries(tenants=2)
    jl = jcore.LMSessionRegistry(211, 8, capacity=2)
    for i in range(2):
        jl.register(f"lm{i}", rng.standard_normal((211, 8)).astype(np.float32),
                    seed=50 + i)
    lreg = tcore.LMSessionRegistry(211, 8, capacity=2)
    lreg.restore_state(*jl.snapshot_state())
    engine = MoLeDeliveryEngine(vreg, "cpu", lm_registry=lreg)
    images = {t: _data(rng, 2) for t in vreg.tenant_ids}
    tokens = {t: rng.integers(0, 211, (2, 9)) for t in lreg.tenant_ids}
    futs = [[] for _ in range(6)]
    with AsyncDeliveryEngine(engine, max_delay_ms=5.0) as front:
        def worker(wid):
            for j in range(6):
                if (wid + j) % 2:
                    t = f"lm{(wid + j) % 2}"
                    futs[wid].append(("lm", t, front.submit(
                        _rq(t, tokens[t], lane="tokens"))))
                else:
                    t = f"t{(wid + j) % 2}"
                    futs[wid].append(("img", t, front.submit(_rq(t, images[t]))))

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        flat = [x for per in futs for x in per]
        assert len(flat) == 36
        rids = [f.request_id for _, _, f in flat]
        assert len(set(rids)) == len(rids)
        for kind, t, f in flat:
            got = f.result(timeout=60).payload
            if kind == "img":
                np.testing.assert_allclose(got, _want(vreg, t, images[t]),
                                           atol=ATOL)
            else:
                np.testing.assert_array_equal(
                    got, np.asarray(jl.session(t).morph_tokens(
                        jnp.asarray(tokens[t]))))
    assert front.pending() == 0


# ---------------------------------------------------------------------------
# deadline and bucket flushing
# ---------------------------------------------------------------------------

def test_deadline_flusher_alone_completes_requests(rng):
    """Nobody calls flush(): the background flusher completes requests on
    the max_delay_ms deadline, and records their latencies."""
    reg = _registry(tenants=2)
    with _front(reg, max_delay_ms=25.0) as front:
        d = _data(rng, 2)
        for t in reg.tenant_ids:
            front.deliver(_rq(t, d), timeout=60)
        t0 = time.monotonic()
        futs = [front.submit(_rq(t, d)) for t in reg.tenant_ids]
        for f in futs:
            f.result(timeout=60)
        assert (time.monotonic() - t0) * 1e3 < 25.0 + SLACK_MS
        stats = front.stats
        assert stats.p50_ms == stats.p50_ms          # not NaN
        assert stats.flushes >= 2                    # all flusher-initiated


@pytest.mark.parametrize("case", ["tight_overtakes_loose_slo",
                                  "tight_behind_loose_request",
                                  "default_deadline"])
def test_request_deadlines_drive_the_flusher(rng, case):
    """Per-request deadline_ms: a tight request flushes on its own deadline
    under a 60 s engine SLO (and the loose one rides along in the same
    flush); without one, a request flushes on the engine's SLO."""
    reg = _registry(tenants=2)
    slo = 25.0 if case == "default_deadline" else 60_000.0
    with _front(reg, max_delay_ms=slo) as front:
        d = _data(rng)
        warm_deadline = None if case == "default_deadline" else 20.0
        for t in reg.tenant_ids:
            front.deliver(_rq(t, d, deadline_ms=warm_deadline), timeout=60)
        if case == "default_deadline":
            t0 = time.monotonic()
            res = front.deliver(_rq("t0", d), timeout=60)
        else:
            loose_ms = None if case == "tight_overtakes_loose_slo" else 50_000.0
            f_loose = front.submit(_rq("t0", d, deadline_ms=loose_ms))
            t0 = time.monotonic()
            res = front.submit(_rq("t1", d, deadline_ms=25.0)).result(timeout=60)
            assert f_loose.done()          # the deadline flush drained it
            np.testing.assert_allclose(f_loose.result().payload,
                                       _want(reg, "t0", d), atol=ATOL)
        assert (time.monotonic() - t0) * 1e3 < 25.0 + SLACK_MS
        np.testing.assert_allclose(res.payload, _want(reg, res.tenant_id, d),
                                   atol=ATOL)


def test_bucket_full_flushes_before_deadline(rng):
    reg = _registry(tenants=1)
    front = _front(reg, max_delay_ms=60_000.0, flush_rows=4, max_rows=8,
                   row_buckets=(1, 2, 4, 8), group_buckets=(1, 2))
    try:
        d = _data(rng, 4)
        feats = front.submit(_rq("t0", d)).result(timeout=60).payload
        np.testing.assert_allclose(feats, _want(reg, "t0", d), atol=ATOL)
    finally:
        front.close()


def test_deadline_heap_prunes_completed_requests(rng):
    reg = _registry(tenants=1)
    with _front(reg, max_delay_ms=5.0) as front:
        d = _data(rng)
        for f in [front.submit(_rq("t0", d)) for _ in range(5)]:
            f.result(timeout=60)
        front.drain(timeout=60)
        with front._cv:
            assert front._oldest_deadline() is None
            assert front._deadline_heap == []


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def test_admission_reject_over_quota_per_tenant(rng):
    reg = _registry(tenants=2)
    front = _front(reg, max_delay_ms=60_000.0, max_inflight_rows=3,
                   admission="reject")
    try:
        d = _data(rng, 2)
        f0 = front.submit(_rq("t0", d))                    # 2 rows in flight
        for _ in range(2):
            with pytest.raises(AdmissionError, match="t0.*over quota"):
                front.submit(_rq("t0", d))                 # 2 + 2 > 3
        f1 = front.submit(_rq("t1", d))    # a neighbour is unaffected
        assert front.stats.rejected == 2
        assert front.stats.rejected_by_tenant == {"t0": 2}
        assert "rejects_by_tenant" in front.stats.summary()
        assert front.inflight_rows() == 4
        front.flush_now()
        for f in (f0, f1):
            assert f.result(timeout=60).payload.shape == (2, GEOM.beta,
                                                          GEOM.n, GEOM.n)
    finally:
        front.close()


@pytest.mark.parametrize("admission", ["block", "reject"])
def test_oversized_request_rejected_in_either_mode(rng, admission):
    """Bigger than the quota itself: blocking would deadlock, so reject."""
    reg = _registry(tenants=1)
    with _front(reg, max_delay_ms=5.0, max_inflight_rows=2,
                admission=admission) as front:
        with pytest.raises(AdmissionError, match="exceeds the per-tenant quota"):
            front.submit(_rq("t0", _data(rng, 3)))
        assert front.stats.rejected == 1


def test_admission_block_applies_backpressure(rng):
    """An over-quota submit waits until a flush frees the quota, then
    succeeds; it is counted once as blocked."""
    reg = _registry(tenants=1)
    eng = _HeldExecuteEngine(reg, "cpu")
    front = AsyncDeliveryEngine(eng, max_delay_ms=5.0, max_inflight_rows=3)
    try:
        d = _data(rng, 2)
        f0 = front.submit(_rq("t0", d))
        assert eng.in_device.wait(timeout=30)   # quota held by a live flush
        out = {}
        th = threading.Thread(
            target=lambda: out.update(f=front.submit(_rq("t0", d))))
        th.start()
        deadline = time.monotonic() + 30
        while not front.stats.blocked and time.monotonic() < deadline:
            time.sleep(0.001)
        assert front.stats.blocked_by_tenant == {"t0": 1}
        assert "f" not in out                   # still waiting for quota
        eng.release.set()
        th.join(timeout=60)
        assert not th.is_alive()
        for f in (f0, out["f"]):
            np.testing.assert_allclose(f.result(timeout=60).payload,
                                       _want(reg, "t0", d), atol=ATOL)
    finally:
        eng.release.set()
        front.close()


# ---------------------------------------------------------------------------
# the front door's API: typed requests, wrapping, cancel, drain, close
# ---------------------------------------------------------------------------

def test_typed_front_door_only(rng):
    reg = _registry(tenants=1)
    d = _data(rng)
    with _front(reg, max_delay_ms=5.0) as front:
        res = front.submit(_rq("t0", d)).result(timeout=60)
        assert isinstance(res, trt.DeliveryResult)
        with pytest.raises(TypeError):
            front.submit("t0", d)
        with pytest.raises(TypeError, match="DeliveryRequest"):
            front.submit("t0")
        with pytest.raises(TypeError):
            front.deliver("t0", d)
        with pytest.raises(KeyError):
            front.submit(_rq("nobody", d))
        for name in ("submit_tokens", "submit_features", "deliver_tokens"):
            assert not hasattr(front, name)


def test_wrapping_an_existing_engine(rng):
    """The front door wraps a pre-built engine; a device and engine kwargs
    are only legal when constructing from a registry."""
    reg = _registry(tenants=1)
    eng = MoLeDeliveryEngine(reg, "cpu", max_rows=8, row_buckets=(1, 2, 4, 8),
                             group_buckets=(1, 2))
    with AsyncDeliveryEngine(eng, max_delay_ms=5.0) as front:
        assert front.engine is eng and front.registry is reg
        d = _data(rng, 2)
        np.testing.assert_allclose(front.deliver(_rq("t0", d), timeout=60).payload,
                                   _want(reg, "t0", d), atol=ATOL)
    for bad in (dict(max_rows=8), dict(device="cpu")):
        with pytest.raises(TypeError):
            AsyncDeliveryEngine(eng, **bad)
    with pytest.raises(ValueError):
        AsyncDeliveryEngine(reg, device="cpu", admission="drop")


def test_front_door_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncDeliveryEngine(_registry(tenants=1))


def test_mixed_sync_submissions_are_left_for_take(rng):
    reg = _registry(tenants=1)
    with _front(reg, max_delay_ms=10_000.0) as front:
        d = _data(rng, 2)
        rid = front.engine.submit(_rq("t0", d))     # bypasses the front door
        fut = front.submit(_rq("t0", d))
        front.flush_now()
        np.testing.assert_allclose(fut.result(timeout=60).payload,
                                   _want(reg, "t0", d), atol=ATOL)
        front.drain(timeout=60)
        assert front.engine.take(rid).shape == (2, GEOM.beta, GEOM.n, GEOM.n)


def test_cancelled_future_does_not_kill_the_flusher(rng):
    reg = _registry(tenants=1)
    with _front(reg, max_delay_ms=10_000.0) as front:
        d = _data(rng)
        doomed = front.submit(_rq("t0", d))
        assert doomed.cancel()
        front.flush_now()
        front.drain(timeout=60)
        fresh = front.submit(_rq("t0", d))
        front.flush_now()
        np.testing.assert_allclose(fresh.result(timeout=60).payload,
                                   _want(reg, "t0", d), atol=ATOL)
        assert doomed.cancelled()


@pytest.mark.parametrize("tenants", [1, 2])
def test_drain_leaves_futures_resolved(rng, tenants):
    """After drain() returns, every future's result is immediately ready."""
    reg = _registry(tenants=tenants)
    with _front(reg, max_delay_ms=10_000.0) as front:
        d = _data(rng)
        futs = [front.submit(_rq(t, d)) for t in reg.tenant_ids for _ in range(3)]
        front.drain(timeout=60)
        assert all(f.done() for f in futs) and front.pending() == 0
        for f in futs:
            assert f.result(timeout=0).payload.shape == (1, GEOM.beta,
                                                         GEOM.n, GEOM.n)


def test_closed_engine_rejects_submissions(rng):
    reg = _registry(tenants=1)
    front = _front(reg, max_delay_ms=5.0)
    d = _data(rng)
    fut = front.submit(_rq("t0", d))
    front.close()
    assert fut.done()                   # close() drains in-flight work first
    with pytest.raises(RuntimeError, match="closed"):
        front.submit(_rq("t0", d))
    front.close()                       # idempotent


def test_deliver_timeout_cancels_and_releases_admission(rng):
    reg = _registry(tenants=1)
    front = _front(reg, max_delay_ms=60_000.0, max_inflight_rows=4)
    try:
        d = _data(rng, 3)
        with pytest.raises(futures.TimeoutError):
            front.deliver(_rq("t0", d), timeout=0.05)
        assert front.inflight_rows() == 0
        assert front.stats.timed_out_requests == 1
        fut = front.submit(_rq("t0", d))          # fits only if freed
        front.flush_now()
        assert fut.result(timeout=60).payload.shape[0] == 3
        front.drain(timeout=60)
        with front._cv:                  # the cancelled result was dropped
            assert not front.engine._results
            assert not front._cancelled
    finally:
        front.close()


def test_deliver_timeout_lost_race_keeps_result(rng):
    reg = _registry(tenants=1)
    with _front(reg, max_delay_ms=5.0) as front:
        fut = front.submit(_rq("t0", _data(rng)))
        fut.result(timeout=60)
        assert front.cancel(fut.request_id) is False
        assert front.stats.timed_out_requests == 0


def test_engine_reset_pending_drops_queued_state(rng):
    eng = MoLeDeliveryEngine(_registry(tenants=1), "cpu")
    d = _data(rng, 2)
    rid = eng.submit(_rq("t0", d))
    eng.reset_pending()
    assert len(eng.queue) == 0
    with pytest.raises(KeyError, match="unknown request id"):
        eng.take(rid)
    assert eng.deliver(_rq("t0", d)).payload.shape == (2, GEOM.beta,
                                                       GEOM.n, GEOM.n)


# ---------------------------------------------------------------------------
# the device step off the lock, and the plan it pinned
# ---------------------------------------------------------------------------

def test_submitters_progress_while_device_step_in_flight(rng):
    reg = _registry(tenants=2)
    eng = _HeldExecuteEngine(reg, "cpu")
    front = AsyncDeliveryEngine(eng, max_delay_ms=5.0)
    try:
        d = _data(rng, 2)
        f0 = front.submit(_rq("t0", d))
        assert eng.in_device.wait(timeout=30)
        f1 = front.submit(_rq("t1", d))        # held device step, free lock
        assert not f0.done()
        eng.release.set()
        for t, f in (("t0", f0), ("t1", f1)):
            np.testing.assert_allclose(f.result(timeout=60).payload,
                                       _want(reg, t, d), atol=ATOL)
        assert eng.stats.submit_wait_quantile_ms(0.95) < 5_000.0
        p50 = eng.stats.submit_wait_quantile_ms(0.5)
        assert p50 == p50 and p50 >= 0.0
        assert 0 <= eng.stats.submit_stalls <= 2
    finally:
        eng.release.set()
        front.close()


def test_held_flush_keeps_its_pinned_secrets_while_prefetch_churns(rng):
    """The flush's device step is held on its first work item while a
    prefetch evicts both tenants of its gidx (one existing tenant, one
    registered meanwhile): the patch clones the pinned stacks, so the held
    items still deliver with the secrets their gidx was built against, and
    the release returns every pin."""
    reg = _registry(tenants=3, capacity=2)          # t0 evicted, t1 t2 resident
    eng = _HeldExecuteEngine(reg, "cpu")
    front = AsyncDeliveryEngine(eng, max_delay_ms=1.0)
    try:
        d = {t: _data(rng, 2) for t in ("t1", "t2")}
        futs = {t: front.submit(_rq(t, d[t])) for t in ("t1", "t2")}
        assert eng.in_device.wait(timeout=30)
        pinned = eng.works[0].items[0].plan
        with front._cv:
            slots_before = {t: reg.slot_for(t) for t in ("t1", "t2")}
        assert pinned.holders == 1
        front.prefetch(["t0"])                      # evicts t1 or t2
        k = rng.standard_normal((GEOM.alpha, GEOM.beta, GEOM.p, GEOM.p))
        with front._cv:
            reg.register("t3", k.astype(np.float32), seed=7)
        front.prefetch(["t3"])                      # evicts the other
        assert set(reg.resident_tenants) == {"t0", "t3"}
        assert eng._plan is not pinned              # patched a clone
        # the pinned stacks still hold the held items' secrets
        for t, s in slots_before.items():
            np.testing.assert_array_equal(pinned.arrays["cores"][s].numpy(),
                                          eng.registry.session(t).provider
                                          ._core.matrix)
        eng.release.set()
        for t, f in futs.items():
            np.testing.assert_allclose(f.result(timeout=60).payload,
                                       _want(reg, t, d[t]), atol=ATOL)
        assert pinned.holders == 0 and eng._plan.holders == 0
        # the patched plan serves the newly resident tenants
        for t in ("t0", "t3"):
            x = _data(rng)
            np.testing.assert_allclose(front.deliver(_rq(t, x), timeout=60).payload,
                                       _want(reg, t, x), atol=ATOL)
    finally:
        eng.release.set()
        front.close()


def test_pins_hold_under_thread_churn(rng):
    """16 submitter threads and a prefetching thread over a registry with
    fewer slots than tenants, with a short switch interval: every request
    delivers its tenant's features exactly once, and every pin is
    returned."""
    reg = _registry(tenants=5, capacity=3)
    datas = {t: _data(rng, 1 + i % 2) for i, t in enumerate(reg.tenant_ids)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stop = threading.Event()
    try:
        with _front(reg, max_delay_ms=1.0) as front:
            futs = [[] for _ in range(16)]

            def submitter(w):
                for j in range(6):
                    t = f"t{(w + j) % 5}"
                    futs[w].append((t, front.submit(_rq(t, datas[t]))))

            def churner():
                i = 0
                while not stop.is_set():
                    front.prefetch([f"t{i % 5}"])
                    i += 1

            ch = threading.Thread(target=churner)
            ch.start()
            threads = [threading.Thread(target=submitter, args=(w,))
                       for w in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            flat = [x for per in futs for x in per]
            results = [(t, f.result(timeout=120)) for t, f in flat]
            stop.set()
            ch.join(timeout=60)
            assert not ch.is_alive()
            assert not any(th.is_alive() for th in threads)
            rids = [r.request_id for _, r in results]
            assert len(set(rids)) == len(rids) == 96
            for t, r in results:
                assert r.tenant_id == t
                np.testing.assert_allclose(r.payload, _want(reg, t, datas[t]),
                                           atol=ATOL)
            assert front.engine._plan.holders == 0
    finally:
        stop.set()
        sys.setswitchinterval(old)


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KeyboardInterrupt("delivered into the flusher"),
], ids=["device_runtime_error", "keyboard_interrupt"])
def test_device_phase_error_marks_the_front_dead(rng, exc):
    """An error from the device phase that is not a SimulatedFailure (a
    kernel wrapper's CUDA error) is fatal: the futures fail with
    EngineDeadError, nothing retries, and the next submit raises at once."""

    class _Failing(MoLeDeliveryEngine):
        def _execute(self, x, gidx, plan):
            raise exc

    reg = _registry(tenants=1)
    eng = _Failing(reg, "cpu")
    front = AsyncDeliveryEngine(eng, max_delay_ms=1.0)
    d = _data(rng)
    fut = front.submit(_rq("t0", d))
    with pytest.raises(EngineDeadError, match="flusher died") as ei:
        fut.result(timeout=60)
    assert ei.value.__cause__ is exc
    with pytest.raises(EngineDeadError):
        front.submit(_rq("t0", d))
    assert front._restarts == 0 and eng.stats.flush_failures == 1
    front.close()                                   # still clean to shut down


# ---------------------------------------------------------------------------
# supervised recovery
# ---------------------------------------------------------------------------

def _traffic(rng, n, tenants):
    return [(f"t{i % tenants}", _data(rng, 1 + i % 2)) for i in range(n)]


@pytest.mark.parametrize("phase", FLUSH_PHASES)
def test_injected_crash_recovers_exactly_once(rng, phase):
    reg = _registry(tenants=3)
    eng = MoLeDeliveryEngine(reg, "cpu",
                             injector=FailureInjector(at_phases={phase}))
    reqs = _traffic(rng, 9, 3)
    with AsyncDeliveryEngine(eng, max_delay_ms=5.0) as front:
        futs = [(t, d, front.submit(_rq(t, d))) for t, d in reqs]
        results = [(t, d, f.result(timeout=120)) for t, d, f in futs]
        rids = [r.request_id for _, _, r in results]
        assert len(set(rids)) == len(rids)
        for t, d, r in results:
            np.testing.assert_allclose(r.payload, _want(reg, t, d), atol=ATOL)
        assert front._restarts == 1 and eng.injector.fired == {phase}
    assert front.pending() == 0
    assert eng._plan.holders <= 1      # a crash before publish strands one pin


def test_restart_budget_exhausts_to_engine_dead(rng):
    inj = FailureInjector(at_phases=set(FLUSH_PHASES))
    eng = MoLeDeliveryEngine(_registry(tenants=1), "cpu", injector=inj)
    front = AsyncDeliveryEngine(eng, max_delay_ms=1.0, max_restarts=1)
    fut = front.submit(_rq("t0", _data(rng)))
    with pytest.raises(EngineDeadError):
        fut.result(timeout=60)
    front.close()


def test_close_timeout_fails_stranded_futures(rng):
    reg = _registry(tenants=1)
    eng = _HeldExecuteEngine(reg, "cpu")
    front = AsyncDeliveryEngine(eng, max_delay_ms=1.0)
    fut = front.submit(_rq("t0", _data(rng)))
    assert eng.in_device.wait(timeout=30)
    with pytest.raises(TimeoutError, match="1 requests still in flight"):
        front.close(timeout=0.2)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0)
    eng.release.set()
    front._flusher.join(timeout=30)
    assert not front._flusher.is_alive()


@settings(max_examples=8, deadline=None)
@given(order=st.permutations(list(range(6))),
       phase=st.sampled_from(list(FLUSH_PHASES)))
def test_crash_recovery_any_arrival_order_property(order, phase):
    rng = np.random.default_rng(11)
    reg = _registry(tenants=3)
    datas = {i: _data(rng, 1 + i % 2) for i in range(6)}
    eng = MoLeDeliveryEngine(reg, "cpu",
                             injector=FailureInjector(at_phases={phase}))
    with AsyncDeliveryEngine(eng, max_delay_ms=2.0) as front:
        futs = {i: front.submit(_rq(f"t{i % 3}", datas[i])) for i in order}
        results = {i: f.result(timeout=120) for i, f in futs.items()}
    rids = [r.request_id for r in results.values()]
    assert len(set(rids)) == len(rids)
    for i, r in results.items():
        np.testing.assert_allclose(r.payload, _want(reg, f"t{i % 3}", datas[i]),
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# persisted snapshots
# ---------------------------------------------------------------------------

def test_flusher_persists_snapshots_between_rounds(rng, tmp_path):
    reg = _registry(tenants=2)
    snapdir = tmp_path / "snaps"
    with _front(reg, max_delay_ms=5.0, snapshot_dir=snapdir) as front:
        for t, d in _traffic(rng, 4, 2):
            front.submit(_rq(t, d))
        front.drain(timeout=120)
        assert front.stats.snapshots >= 1
    ckpt = CheckpointManager(snapdir)
    assert ckpt.latest_step() is not None
    snap = trt.EngineSnapshot.load(ckpt)
    assert "vision" in snap.meta["registries"]
    assert not list(snapdir.glob("*.tmp"))
    with pytest.raises(ValueError, match="snapshot_dir"):
        _front(reg).snapshot_now()


_FRONTS = {
    "port": (lambda reg: MoLeDeliveryEngine(reg, "cpu"), AsyncDeliveryEngine,
             DeliveryRequest),
    "reference": (lambda reg: jrt.MoLeDeliveryEngine(reg, backend="jnp"),
                  jrt.AsyncDeliveryEngine, jrt.DeliveryRequest),
}


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("reference", "port"), ("port", "reference"),
])
def test_snapshot_dir_restores_into_a_fresh_front(rng, tmp_path, writer,
                                                  reader):
    """Process-restart shape: one front door delivers some requests, holds
    others pending on a 60 s SLO and persists them (``snapshot_now``); a
    fresh front door of either package over a registry with other secrets
    restores from the directory and hands back futures that resolve to the
    writer's deliveries, each rid once; new work continues the id space."""
    jreg, treg = _registries(tenants=2)
    snapdir = tmp_path / "snaps"
    make_engine, Front, Request = _FRONTS[writer]
    # Only snapshot_now persists: the reference's CheckpointManager is not
    # safe against a flusher round's save running beside it (ROADMAP,
    # Queue 3), which the port's is (tests/test_torch_checkpoint.py).
    wfront = Front(make_engine(jreg if writer == "reference" else treg),
                   max_delay_ms=60_000.0, snapshot_dir=snapdir,
                   snapshot_every=10**9)
    reqs = _traffic(rng, 6, 2)
    for t, d in reqs[:2]:
        wfront.submit(Request(t, d))
    wfront.drain(timeout=120)                        # delivered and taken
    pend = [wfront.submit(Request(t, d)).request_id for t, d in reqs[2:]]
    step = wfront.snapshot_now()
    wfront.close()         # the "crashed" process (its later rounds persist)

    jreg2, treg2 = _registries(seed=9, tenants=2)
    make_engine, Front, Request = _FRONTS[reader]
    # A 60 s SLO: nothing flushes (or snapshots) until flush_now().
    with Front(make_engine(jreg2 if reader == "reference" else treg2),
               max_delay_ms=60_000.0, snapshot_dir=snapdir) as rfront:
        futs = rfront.restore(step=step)
        assert sorted(futs) == pend
        with pytest.raises(RuntimeError, match="in flight"):
            rfront.restore(step=step)
        rfront.flush_now()
        for rid, (t, d) in zip(pend, reqs[2:]):
            got = futs[rid].result(timeout=120)
            assert got.request_id == rid and got.tenant_id == t
            np.testing.assert_allclose(np.asarray(got.payload),
                                       _want(treg, t, d), atol=ATOL)
            with pytest.raises(KeyError):            # exactly once
                rfront.engine.take(rid)
        t, d = reqs[0]
        fresh = rfront.submit(Request(t, d))
        assert fresh.request_id > max(pend)
        rfront.flush_now()
        np.testing.assert_allclose(np.asarray(fresh.result(timeout=120).payload),
                                   _want(treg, t, d), atol=ATOL)


def test_snapshot_steps_continue_across_restarts(rng, tmp_path):
    """Three processes in turn on one snapshot directory: the second numbers
    its snapshots above the first's, so retention keeps them, and the third
    restores the second's state and continues its id space (a restart that
    numbered from 1 again would lose its snapshots to retention and hand
    the third the first's, reusing the second's request ids)."""
    reg = _registry(tenants=2)
    snapdir = tmp_path / "snaps"
    last_rid = None
    for run in range(3):
        with _front(reg, max_delay_ms=5.0, snapshot_dir=snapdir) as front:
            if run:
                front.restore()
            for _ in range(4):                   # four flush rounds
                r = front.deliver(_rq("t0", _data(rng)), timeout=60)
                assert last_rid is None or r.request_id > last_rid
                last_rid = r.request_id
        steps = sorted(int(p.name.split("_")[1]) for p in snapdir.glob("step_*"))
        assert steps == [4 * run + 2, 4 * run + 3, 4 * run + 4], steps


# ---------------------------------------------------------------------------
# prefetch through the front door
# ---------------------------------------------------------------------------

def test_prefetch_under_lock(rng):
    reg = _registry(tenants=3, capacity=2)
    with _front(reg, max_delay_ms=5.0) as front:
        slots = front.prefetch(["t0"])
        assert reg.is_resident("t0") and "t0" in slots
        d = _data(rng)
        res = front.submit(_rq("t0", d)).result(timeout=60)
        np.testing.assert_allclose(res.payload, _want(reg, "t0", d), atol=ATOL)


class _PrefetchSignal(MoLeDeliveryEngine):
    """Signals each predictive prefetch that staged a tenant."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.staged = []
        self.prefetched = threading.Event()

    def predictive_prefetch(self, horizon_ms=50.0, now=None):
        out = super().predictive_prefetch(horizon_ms, now)
        if out:
            self.staged.extend(out)
            self.prefetched.set()
        return out


def test_prefetch_horizon_stages_predicted_tenants_between_rounds(rng):
    """With prefetch_horizon_ms the flusher runs the predictive prefetch
    after a round: a periodic tenant evicted between its ticks is staged
    before its next one, and that arrival scores a hit."""
    reg = _registry(tenants=3, capacity=2)
    now = [0.0]
    eng = _PrefetchSignal(reg, "cpu", max_rows=8, row_buckets=(1, 2, 4, 8),
                          group_buckets=(1, 2), clock=lambda: now[0])
    with AsyncDeliveryEngine(eng, max_delay_ms=1.0,
                             prefetch_horizon_ms=5_000.0) as front:
        for tick in range(4):                  # t0 ticks every 10 s
            now[0] = 10.0 * tick
            front.deliver(_rq("t0", _data(rng)), timeout=60)
        front.prefetch(["t1", "t2"])
        assert not reg.is_resident("t0")
        now[0] = 38.0                          # next t0 tick due at 40
        front.deliver(_rq("t1", _data(rng)), timeout=60)
        assert eng.prefetched.wait(timeout=60)
        assert eng.staged == ["t0"]
        now[0] = 40.0
        d = _data(rng)
        res = front.deliver(_rq("t0", d), timeout=60)
        np.testing.assert_allclose(res.payload, _want(reg, "t0", d), atol=ATOL)
        assert (eng.stats.prefetch_hits, eng.stats.prefetch_misses) == (1, 0)
