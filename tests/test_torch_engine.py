"""The port's delivery engine (``repro_torch.runtime.engine``) on the CPU
against the JAX reference engine (``repro.runtime.engine``, ``jnp``
backend).

Both engines get the same tenants: a reference ``SessionRegistry`` is
snapshotted and restored into the port's registry, so the secrets are
byte-equal.  The same traffic must then coalesce into the same microbatches
(slot indices, padded rows, request slices) and deliver the same features
within 1e-5 — including when capacity is below the tenant count and slots
are evicted inside one flush round (the port's copy-on-write of its secret
stacks), and across snapshot/restore and crash replay.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.runtime as jrt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.kernels import grouped_aug_gemm  # noqa: E402

ATOL = 1e-5
SMALL = dict(max_rows=8, row_buckets=(1, 2, 4, 8), group_buckets=(1, 2, 4))


def _registries(rng, shape=(2, 4, 6, 3), tenants=3, kappa=2, capacity=None):
    jg = jcore.ConvGeometry(*shape)
    jreg = jcore.SessionRegistry(jg, kappa=kappa, capacity=capacity)
    for i in range(tenants):
        k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(
            np.float32
        ) / np.sqrt(jg.alpha * jg.p * jg.p)
        jreg.register(f"t{i}", k, seed=100 + i)
    treg = tcore.SessionRegistry(
        tcore.ConvGeometry(*shape), kappa=kappa, capacity=capacity
    )
    treg.restore_state(*jreg.snapshot_state())
    return jreg, treg


def _engines(jreg, treg, **kw):
    return (
        jrt.MoLeDeliveryEngine(jreg, backend="jnp", **kw),
        trt.MoLeDeliveryEngine(treg, "cpu", **kw),
    )


def _requests(rng, geom, plan):
    """plan: [(tenant, n_images, priority)] -> one request pair each."""
    out = []
    for tenant, n, prio in plan:
        d = rng.standard_normal((n, geom.alpha, geom.m, geom.m)).astype(
            np.float32
        )
        out.append((
            jrt.DeliveryRequest(tenant, d, priority=prio),
            trt.DeliveryRequest(tenant, d, priority=prio),
        ))
    return out


def _submit_both(jeng, teng, reqs):
    rids = [(jeng.submit(jq), teng.submit(tq)) for jq, tq in reqs]
    assert all(a == b for a, b in rids)
    return [a for a, _ in rids]


def _flush_both(jeng, teng):
    """Phase-split flush of both engines in lockstep, asserting the same
    microbatches round by round; returns the port's round plans too."""
    rounds = []
    while True:
        jw, tw = jeng.begin_flush(), teng.begin_flush()
        assert (jw is None) == (tw is None)
        if jw is None:
            return rounds
        assert len(jw.items) == len(tw.items)
        for ji, ti in zip(jw.items, tw.items):
            np.testing.assert_array_equal(ti.mb.group_tenant, ji.mb.group_tenant)
            assert ti.mb.group_tenant.dtype == np.int32
            np.testing.assert_array_equal(ti.mb.x, ji.mb.x)
            assert [dataclasses.astuple(s) for s in ti.mb.slices] == [
                dataclasses.astuple(s) for s in ji.mb.slices
            ]
            assert (ti.mb.n_real_groups, ti.mb.n_real_rows,
                    ti.mb.n_clamped_padding) == (
                ji.mb.n_real_groups, ji.mb.n_real_rows, ji.mb.n_clamped_padding
            )
        rounds.append([item.plan for item in tw.items])
        jeng.execute_flush(jw)
        teng.execute_flush(tw)
        jdone, tdone = jeng.publish_flush(jw), teng.publish_flush(tw)
        assert sorted(jdone) == sorted(tdone)


def _assert_results_match(jeng, teng, rids, treg=None, reqs=None):
    for i, rid in enumerate(rids):
        jr, tr = jeng.take_result(rid), teng.take_result(rid)
        assert (tr.request_id, tr.tenant_id, tr.lane, tr.priority) == (
            jr.request_id, jr.tenant_id, jr.lane, jr.priority
        )
        assert tr.payload.shape == jr.payload.shape
        np.testing.assert_allclose(tr.payload, jr.payload, atol=ATOL)
        if treg is not None:
            data = torch.from_numpy(reqs[i][1].payload)
            want = treg.session(tr.tenant_id).deliver(data).numpy()
            np.testing.assert_allclose(tr.payload, want, atol=ATOL)


def _stats(eng):
    s = eng.stats
    return (s.requests, s.rows_in, s.rows_padded, s.microbatches, s.flushes,
            s.padding_clamp_count, sorted(s.bucket_shapes))


def test_mixed_traffic_matches_reference(rng):
    """Ragged sizes and priorities: padding in every microbatch, requests
    spanning groups."""
    jreg, treg = _registries(rng)
    jeng, teng = _engines(jreg, treg, **SMALL)
    plan = [(f"t{i % 3}", 1 + i % 4, i % 2) for i in range(9)]
    reqs = _requests(rng, treg.geom, plan)
    rids = _submit_both(jeng, teng, reqs)
    _flush_both(jeng, teng)
    assert _stats(teng) == _stats(jeng)
    _assert_results_match(jeng, teng, rids, treg, reqs)


def test_large_request_spans_microbatches(rng):
    jreg, treg = _registries(rng, tenants=1)
    kw = dict(max_rows=4, row_buckets=(1, 2, 4), group_buckets=(1, 2))
    jeng, teng = _engines(jreg, treg, **kw)
    reqs = _requests(rng, treg.geom, [("t0", 19, 0)])
    rids = _submit_both(jeng, teng, reqs)
    _flush_both(jeng, teng)
    assert teng.stats.microbatches >= 3
    _assert_results_match(jeng, teng, rids, treg, reqs)


def test_out_of_order_traffic_partial_table(rng):
    """T < capacity, arrivals out of slot order: groups come out slot-sorted
    and the kernels read a partial, non-identity slot table."""
    jreg, treg = _registries(rng, shape=(3, 16, 8, 3), tenants=4, kappa=1,
                             capacity=8)
    jeng, teng = _engines(jreg, treg)
    reqs = _requests(rng, treg.geom, [("t3", 2, 0), ("t1", 1, 0),
                                      ("t0", 3, 0), ("t2", 1, 0)])
    rids = _submit_both(jeng, teng, reqs)
    _flush_both(jeng, teng)
    _assert_results_match(jeng, teng, rids, treg, reqs)


@pytest.mark.parametrize("kappa", [1, 2])
def test_eviction_inside_one_flush_round_copy_on_write(rng, kappa):
    """Capacity 2, five tenants: each flush round coalesces several
    microbatches and the later ones evict slots the earlier ones point at.
    Same microbatches and features as the reference; the earlier items keep
    their own stacks."""
    jreg, treg = _registries(rng, tenants=5, kappa=kappa, capacity=2)
    jeng, teng = _engines(jreg, treg, **SMALL)
    plan = [(f"t{(3 * i) % 5}", 1 + i % 3, 0) for i in range(10)]
    reqs = _requests(rng, treg.geom, plan)
    rids = _submit_both(jeng, teng, reqs)
    rounds = _flush_both(jeng, teng)
    assert treg.evictions == jreg.evictions > 0
    assert any(len({id(p) for p in plans}) > 1 for plans in rounds)
    # every pin was released once the round executed
    assert all(p.holders == 0 for plans in rounds for p in plans)
    _assert_results_match(jeng, teng, rids, treg, reqs)


def test_plan_patched_in_place_when_no_work_holds_it(rng):
    """Outside a flush round nothing holds the stacks: registration into a
    free slot and prefetch write in place, no clone."""
    jreg, treg = _registries(rng, tenants=2, capacity=4)
    teng = trt.MoLeDeliveryEngine(treg, "cpu")
    plan = teng._refresh_plan()
    augs = plan.arrays["augs"]
    k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    treg.register("t9", k, seed=5)
    assert teng.prefetch(["t9"]) == {"t9": treg.slot_for("t9")}
    assert teng._plan is plan and plan.arrays["augs"] is augs
    assert plan.version == treg.version
    np.testing.assert_array_equal(augs.numpy(), treg.stacked_aug_matrices())


def test_prefetch_and_predictive_prefetch_match_reference(rng):
    jreg, treg = _registries(rng, tenants=4, capacity=2)
    clock = {"t": 0.0}
    kw = dict(clock=lambda: clock["t"])
    jeng, teng = _engines(jreg, treg, **kw)
    assert teng.prefetch(["t3", "t0"]) == jeng.prefetch(["t3", "t0"])
    assert treg.resident_tenants == jreg.resident_tenants
    # t1 arrives every 10 ms, then goes quiet and gets evicted
    for step in range(6):
        clock["t"] = step * 0.010
        reqs = _requests(rng, treg.geom, [("t1", 1, 0)])
        _submit_both(jeng, teng, reqs)
        _flush_both(jeng, teng)
    jeng.prefetch(["t2", "t3"])
    teng.prefetch(["t2", "t3"])
    clock["t"] = 0.055
    assert teng.predictive_prefetch(20.0) == jeng.predictive_prefetch(20.0)
    assert treg.resident_tenants == jreg.resident_tenants
    clock["t"] = 0.060
    reqs = _requests(rng, treg.geom, [("t1", 1, 0)])
    rids = _submit_both(jeng, teng, reqs)
    _flush_both(jeng, teng)
    assert (teng.stats.prefetch_hits, teng.stats.prefetch_misses) == (
        jeng.stats.prefetch_hits, jeng.stats.prefetch_misses
    )
    assert teng.stats.prefetch_hits == 1
    _assert_results_match(jeng, teng, rids, treg, reqs)


def test_snapshot_restores_across_packages(rng):
    """A reference engine's snapshot (pending + finished requests) restores
    into the port, which then delivers each pending id exactly once with
    the reference's results; the port's own snapshot round-trips too."""
    jreg, treg = _registries(rng, tenants=3, capacity=2)
    jeng, teng = _engines(jreg, treg, **SMALL)
    first = _requests(rng, treg.geom, [("t0", 2, 0), ("t2", 1, 1)])
    done_rids = _submit_both(jeng, teng, first)
    _flush_both(jeng, teng)
    later = _requests(rng, treg.geom, [("t1", 3, 0), ("t0", 1, 0),
                                       ("t2", 2, 0)])
    pending = _submit_both(jeng, teng, later)
    snap = jeng.snapshot()

    t2reg = tcore.SessionRegistry(treg.geom, kappa=2, capacity=2)
    restored = trt.MoLeDeliveryEngine(t2reg, "cpu", **SMALL)
    assert restored.restore(snap) == pending
    jeng.restore(snap)
    _flush_both(jeng, restored)
    _assert_results_match(jeng, restored, done_rids + pending)

    # the port's own snapshot -> a fresh port engine
    more = _requests(rng, treg.geom, [("t2", 2, 0), ("t1", 1, 0)])
    rids = [teng.submit(tq) for _, tq in more]
    own = teng.snapshot()
    again = trt.MoLeDeliveryEngine(
        tcore.SessionRegistry(treg.geom, kappa=2, capacity=2), "cpu", **SMALL
    )
    assert again.restore(own) == [r for r in pending + rids]
    again.flush()
    for rid, (_, tq) in zip(rids, more):
        want = treg.session(tq.tenant_id).deliver(
            torch.from_numpy(tq.payload)
        ).numpy()
        np.testing.assert_allclose(again.take(rid), want, atol=ATOL)
    assert again.stats.restores == 1


@pytest.mark.parametrize("phase", ["coalesce", "device", "publish"])
def test_requeue_inflight_after_injected_crash(rng, phase):
    """A flush dies at ``phase`` in both engines; requeue_inflight replays
    every in-flight request under its id, delivered exactly once."""
    jreg, treg = _registries(rng, tenants=3, capacity=2)
    jeng = jrt.MoLeDeliveryEngine(
        jreg, backend="jnp", injector=jrt.FailureInjector(at_phases={phase}),
        **SMALL,
    )
    teng = trt.MoLeDeliveryEngine(
        treg, "cpu", injector=trt.FailureInjector(at_phases={phase}), **SMALL
    )
    reqs = _requests(rng, treg.geom, [(f"t{i % 3}", 1 + i % 2, 0)
                                      for i in range(7)])
    rids = _submit_both(jeng, teng, reqs)
    with pytest.raises(jrt.SimulatedFailure):
        jeng.flush()
    with pytest.raises(trt.SimulatedFailure):
        teng.flush()
    assert teng.requeue_inflight() == jeng.requeue_inflight() == rids
    _flush_both(jeng, teng)
    _assert_results_match(jeng, teng, rids, treg, reqs)


def test_engine_without_device_needs_cuda(rng, monkeypatch):
    """device=None means the card: without CUDA the engine raises instead of
    running somewhere else."""
    _, treg = _registries(rng, tenants=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.MoLeDeliveryEngine(treg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.MoLeDeliveryEngine(treg, "cuda")
    assert trt.MoLeDeliveryEngine(treg, "cpu").device == torch.device("cpu")


def test_unported_lanes_raise(rng):
    _, treg = _registries(rng, tenants=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        trt.MoLeDeliveryEngine(treg, "cpu", lm_registry=object())
    eng = trt.MoLeDeliveryEngine(treg, "cpu")
    with pytest.raises(ValueError, match="no LM registry"):
        eng.submit(trt.DeliveryRequest(
            "t0", np.zeros((1, 4), np.int32), lane="tokens"
        ))
    with pytest.raises(KeyError):
        eng.submit(trt.DeliveryRequest("nobody", np.zeros((1, 72), np.float32)))
    with pytest.raises(ValueError, match="empty payload"):
        eng.submit(trt.DeliveryRequest("t0", np.zeros((0, 72), np.float32)))


def test_cpu_engine_launches_no_kernel_and_delivers_rows(rng):
    """Pre-rolled rows deliver like images; the CPU run counts no launches."""
    _, treg = _registries(rng)
    eng = trt.MoLeDeliveryEngine(treg, "cpu")
    d = rng.standard_normal((3, 2, 6, 6)).astype(np.float32)
    before = grouped_aug_gemm.launches
    a = eng.deliver(trt.DeliveryRequest("t1", d)).payload
    b = eng.deliver(trt.DeliveryRequest("t1", d.reshape(3, -1))).payload
    np.testing.assert_array_equal(a, b)
    assert grouped_aug_gemm.launches == before
    want = treg.session("t1").deliver(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(a, want, atol=ATOL)
    assert "microbatches=2" in eng.stats.summary()
    with pytest.raises(KeyError, match="unknown request id"):
        eng.take(12345)
