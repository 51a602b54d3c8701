"""The port's checkpoint manager (``repro_torch.checkpoint``) and engine
snapshots on disk, beside the reference's (``repro.checkpoint``).

The manager is held as ``tests/test_checkpoint.py`` holds the reference's
(round trip, async save, retention, crash mid-save, the stale-tmp sweep),
and a directory written by either package loads in the other: the same
manifest (keys, leaf paths, file names, dtype tags, shapes) and the same
leaves, bfloat16 included.  An engine snapshot persisted by either
package's engine restores into the other's, and the restored engine
delivers every request exactly once, equal to the original.
"""
import json
import sys
import threading

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

GEOM = (2, 4, 6, 3)             # alpha, beta, m, p
ATOL = 1e-5


def _arrays(rng):
    return {
        "a": rng.standard_normal((4, 8)).astype(np.float32),
        "b": rng.integers(0, 10, (3,)).astype(np.int32),
        "c": rng.standard_normal((2, 2)).astype(np.float32),
    }


def _tree(rng):
    """The reference test's tree in torch: fp32, int32 and bf16 leaves."""
    a = _arrays(rng)
    return {
        "a": torch.from_numpy(a["a"]),
        "nested": {"b": torch.from_numpy(a["b"]),
                   "c": torch.from_numpy(a["c"]).to(torch.bfloat16)},
    }


def _jtree(tree):
    return {
        "a": jnp.asarray(tree["a"].numpy()),
        "nested": {"b": jnp.asarray(tree["nested"]["b"].numpy()),
                   "c": jnp.asarray(tree["nested"]["c"].float().numpy(),
                                    jnp.bfloat16)},
    }


def _leaves(tree):
    return [tree["a"], tree["nested"]["b"], tree["nested"]["c"]]


def _assert_tree_equal(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert isinstance(g, torch.Tensor) and g.dtype == w.dtype
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the manager's own contract
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path, rng):
    m = CheckpointManager(tmp_path, async_save=False)
    t = _tree(rng)
    m.save(7, t, extra={"data": {"index": 42}})
    assert m.latest_step() == 7
    restored, extra = m.restore(7, like=t)
    assert extra == {"data": {"index": 42}}
    _assert_tree_equal(restored, t)
    # Numpy leaves come back as numpy; lists and tuples keep their kind.
    like = {"x": [np.zeros(3, np.float32), (np.zeros(2, np.int64),)],
            "none": None}
    m.save(8, {"x": [np.arange(3, dtype=np.float32),
                     (np.arange(2, dtype=np.int64),)], "none": None})
    back, _ = m.restore(8, like=like)
    assert back["none"] is None and isinstance(back["x"][1], tuple)
    np.testing.assert_array_equal(back["x"][0], np.arange(3, dtype=np.float32))
    assert back["x"][1][0].dtype == np.int64


def test_restore_checks_shapes_and_refuses_shardings(tmp_path, rng):
    m = CheckpointManager(tmp_path, async_save=False)
    t = _tree(rng)
    m.save(1, t)
    with pytest.raises(ValueError, match="shape"):
        m.restore(1, like=dict(t, a=torch.zeros(3, 3)))
    with pytest.raises(NotImplementedError, match="shardings"):
        m.restore(1, like=t, shardings=object())


def test_async_save_then_restore_sees_the_saved_values(tmp_path, rng):
    m = CheckpointManager(tmp_path, async_save=True)
    t = _tree(rng)
    want = {k: v.clone() for k, v in t.items() if k == "a"}
    m.save(3, t)
    t["a"].add_(1.0)            # an in-place update after save() returned
    m.wait()
    assert m.latest_step() == 3
    restored, _ = m.restore(3, like=t)
    assert torch.equal(restored["a"], want["a"])


def test_retention(tmp_path, rng):
    m = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _tree(rng)
    for s in (1, 2, 3, 4):
        m.save(s, t)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


@pytest.mark.parametrize("when", ["construction", "next_save"])
def test_stale_tmp_is_swept(tmp_path, rng, when):
    """A crash mid-save leaves a .tmp dir: it is ignored by latest_step and
    swept on construction and on every later save of a live manager."""
    m = CheckpointManager(tmp_path, async_save=False)
    t = _tree(rng)
    m.save(5, t)
    bad = tmp_path / "step_00000009.tmp"
    bad.mkdir()
    (bad / "garbage").write_text("x")
    assert m.latest_step() == 5
    if when == "construction":
        assert CheckpointManager(tmp_path, async_save=False).latest_step() == 5
    else:
        m.save(6, t)
        assert m.latest_step() == 6
    assert not bad.exists()


def test_tmp_sweep_does_not_race_async_writer(tmp_path, rng):
    """The per-save sweep joins the in-flight async writer first: a live
    .tmp mid-write is never the sweep's victim."""
    m = CheckpointManager(tmp_path, async_save=True)
    t = _tree(rng)
    m.save(1, t)
    m.save(2, t)                 # wait()s on save 1's writer, then sweeps
    m.wait()
    assert m.latest_step() == 2
    assert not list(tmp_path.glob("*.tmp"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").load()


@pytest.mark.parametrize("async_save", [True, False])
def test_concurrent_saves_from_threads(tmp_path, async_save):
    """Four threads save to one manager with a short switch interval (as the
    async delivery engine's flusher and ``snapshot_now`` do): no save
    fails, and every step is on disk, complete, with no .tmp left."""
    m = CheckpointManager(tmp_path, keep=1000, async_save=async_save)
    errors = []

    def saver(base):
        try:
            for i in range(25):
                m.save(base + i, {"x": np.full(64, base + i, np.float32)},
                       extra={"step": base + i})
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saver, args=(k * 100,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    m.wait()
    assert not errors and not any(th.is_alive() for th in threads)
    steps = [k * 100 + i for k in range(4) for i in range(25)]
    assert sorted(int(p.name.split("_")[1])
                  for p in tmp_path.glob("step_*")) == steps
    for step in steps[::17]:
        arrays, extra = m.load(step)
        assert extra == {"step": step}
        np.testing.assert_array_equal(arrays["x"], np.full(64, step, np.float32))
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# one on-disk layout for both packages
# ---------------------------------------------------------------------------

def test_port_writes_the_reference_layout(tmp_path, rng):
    """The same tree saved by each package: equal manifests (leaf paths,
    file names, dtype tags, shapes, extra) and equal leaf files."""
    t = _tree(rng)
    CheckpointManager(tmp_path / "port", async_save=False).save(
        4, t, extra={"k": [1, "x"]}
    )
    JManager(tmp_path / "ref", async_save=False).save(
        4, _jtree(t), extra={"k": [1, "x"]}
    )
    dp, dr = tmp_path / "port" / "step_00000004", tmp_path / "ref" / "step_00000004"
    mp = json.loads((dp / "manifest.json").read_text())
    mr = json.loads((dr / "manifest.json").read_text())
    assert mp == mr
    assert [e["dtype"] for e in mp["leaves"]] == ["float32", "int32", "bfloat16"]
    for e in mp["leaves"]:
        assert (dp / e["file"]).read_bytes() == (dr / e["file"]).read_bytes()


def test_directories_load_across_packages(tmp_path, rng):
    t = _tree(rng)
    # reference -> port, through restore(like=) and the flat load()
    JManager(tmp_path / "ref", async_save=False).save(1, _jtree(t),
                                                      extra={"e": 1})
    port_side = CheckpointManager(tmp_path / "ref")
    restored, extra = port_side.restore(1, like=t)
    assert extra == {"e": 1}
    _assert_tree_equal(restored, t)
    flat = {"x": rng.standard_normal((3, 2)).astype(np.float32),
            "y/z": np.arange(4, dtype=np.int64)}
    JManager(tmp_path / "ref", async_save=False).save(
        2, dict(flat, w=jnp.ones((2,), jnp.bfloat16))
    )
    arrays, _ = port_side.load()
    np.testing.assert_array_equal(arrays["x"], flat["x"])
    np.testing.assert_array_equal(arrays["y/z"], flat["y/z"])
    assert arrays["w"].dtype == torch.bfloat16
    assert torch.equal(arrays["w"], torch.ones(2, dtype=torch.bfloat16))
    # port -> reference
    CheckpointManager(tmp_path / "port", async_save=False).save(3, t)
    jt, _ = JManager(tmp_path / "port").restore(3, like=_jtree(t))
    for g, w in zip(
        [jt["a"], jt["nested"]["b"], jt["nested"]["c"]], _leaves(t)
    ):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      w.float().numpy())
    assert jt["nested"]["c"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# engine snapshots on disk, across packages
# ---------------------------------------------------------------------------

def _registries(seed, tenants=3):
    rng = np.random.default_rng(seed)
    jg = jcore.ConvGeometry(*GEOM)
    jreg = jcore.SessionRegistry(jg, kappa=2)
    for i in range(tenants):
        k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(
            np.float32) / np.sqrt(jg.alpha * jg.p * jg.p)
        jreg.register(f"t{i}", k, seed=100 + seed + i)
    treg = tcore.SessionRegistry(tcore.ConvGeometry(*GEOM), kappa=2)
    treg.restore_state(*jreg.snapshot_state())
    return jreg, treg


def _traffic(rng, n=6, tenants=3):
    g = jcore.ConvGeometry(*GEOM)
    return [
        (f"t{i % tenants}",
         rng.standard_normal((1 + i % 2, g.alpha, g.m, g.m)).astype(np.float32))
        for i in range(n)
    ]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_engine_snapshot_dir_restores_across_packages(tmp_path, rng, direction):
    """A snapshot with done-but-untaken and still-pending requests, saved by
    one package's engine through its CheckpointManager, restores into the
    other's fresh engine over a registry holding other secrets: every rid is
    redeemable exactly once, equal to the writer's own deliveries."""
    jreg, treg = _registries(0)
    reqs = _traffic(rng)
    if direction == "reference_to_port":
        writer = jrt.MoLeDeliveryEngine(jreg, backend="jnp")
        Request, Manager, Snapshot = jrt.DeliveryRequest, JManager, jrt.EngineSnapshot
        reader = trt.MoLeDeliveryEngine(_registries(7)[1], "cpu")
        ReadManager, ReadSnapshot = CheckpointManager, trt.EngineSnapshot
    else:
        writer = trt.MoLeDeliveryEngine(treg, "cpu")
        Request, Manager, Snapshot = trt.DeliveryRequest, CheckpointManager, trt.EngineSnapshot
        reader = jrt.MoLeDeliveryEngine(_registries(7)[0], backend="jnp")
        ReadManager, ReadSnapshot = JManager, jrt.EngineSnapshot
    done = [writer.submit(Request(t, d)) for t, d in reqs[:3]]
    writer.flush()                                 # done, never taken
    pend = [writer.submit(Request(t, d)) for t, d in reqs[3:]]
    snap = writer.snapshot()
    snap.save(Manager(tmp_path / "snaps", async_save=False), 1)
    assert snap.meta["next_rid"] == len(reqs)

    restored = reader.restore(ReadSnapshot.load(ReadManager(tmp_path / "snaps")))
    assert restored == pend
    reader.flush()
    for rid, (t, d) in zip(done + pend, reqs):
        want = treg.session(t).deliver(torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(np.asarray(reader.take(rid)), want, atol=ATOL)
        with pytest.raises(KeyError):                # exactly once
            reader.take(rid)
    # rid allocation resumes past the snapshot: no collision with replays
    t, d = reqs[0]
    assert reader.submit(
        (trt if direction == "reference_to_port" else jrt).DeliveryRequest(t, d)
    ) >= len(reqs)


def test_restore_refuses_mismatched_registry(rng):
    """A snapshot restores only into an engine whose registries match it:
    not another kappa, not an engine without the vision lane."""
    _, treg = _registries(0, tenants=2)
    eng = trt.MoLeDeliveryEngine(treg, "cpu")
    eng.submit(trt.DeliveryRequest("t0", _traffic(rng, 1, 1)[0][1]))
    snap = eng.snapshot()
    other = tcore.SessionRegistry(tcore.ConvGeometry(*GEOM), kappa=3)
    with pytest.raises(ValueError, match="config mismatch"):
        trt.MoLeDeliveryEngine(other, "cpu").restore(snap)
    lreg = tcore.LMSessionRegistry(64, 4, capacity=1)
    lreg.register("lm0", rng.standard_normal((64, 4)).astype(np.float32),
                  seed=1)
    with pytest.raises(ValueError, match="vision registry"):
        trt.MoLeDeliveryEngine(lm_registry=lreg, device="cpu").restore(snap)
