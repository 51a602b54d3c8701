"""The continuous LM ``features`` lane of the port on the CPU against the JAX
reference: ``EmbeddingMorpher`` and ``fuse_aug_projection``
(``repro_torch.core.lm``), the registry's ``d_in``/``d_out`` lane, the
engine's features lane against the reference engine, the features
normalizer, snapshots across packages, and ``fuse_lm_params``
(``repro_torch.core.deploy``) on the reference's smoke parameter dicts.

Tolerances: morph cores, output permutations and token permutations are
byte-equal (the same numpy code draws them).  A fused projection or a
delivered feature is a sum of products in fp32 taken in another order than
jnp's, so it is held at 1e-5 x max|reference| (the depth here is at most
64, so fp32 rounding stays near 1e-6 of that scale).  The unfuse property
(delivered == x @ W_in) is held against float64 at the same 1e-5 x max.
Gathers (embedding rows, head columns) are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.lm as jlm  # noqa: E402
import repro.runtime as jrt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.deploy import fuse_lm_params as j_fuse_lm_params  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.core.deploy import fuse_lm_params  # noqa: E402
from repro_torch.kernels import grouped_aug_gemm, grouped_block_diag_matmul  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402

REL = 1e-5
VOCAB, D, D_IN, D_OUT = 64, 16, 12, 10
SMALL = dict(max_rows=8, row_buckets=(1, 2, 4, 8), group_buckets=(1, 2, 4),
             seq_buckets=(4, 8, 16))


def _hold(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _lm_registries(rng, tenants=4, kappa=2, capacity=None, d_in=D_IN,
                   d_out=D_OUT):
    """A reference and a port registry with the same tenants, registered
    independently from the same seeds and the same weights."""
    jreg = jlm.LMSessionRegistry(VOCAB, D, d_in=d_in, d_out=d_out,
                                 kappa=kappa, capacity=capacity)
    treg = tlm.LMSessionRegistry(VOCAB, D, d_in=d_in, d_out=d_out,
                                 kappa=kappa, capacity=capacity)
    w_ins = {}
    for i in range(tenants):
        emb = rng.standard_normal((VOCAB, D)).astype(np.float32)
        w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
            np.float32)
        jreg.register(f"lm{i}", emb, w_in=w, seed=40 + i)
        treg.register(f"lm{i}", emb, w_in=w, seed=40 + i)
        w_ins[f"lm{i}"] = w
    return jreg, treg, w_ins


# ---------------------------------------------------------------------------
# core.lm: the continuous secrets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["orthogonal", "uniform"])
@pytest.mark.parametrize("d_in,kappa,d_out",
                         [(12, 1, None), (12, 3, 7), (48, 4, None)])
def test_embedding_morpher_cores_byte_equal(mode, d_in, kappa, d_out):
    want = jlm.EmbeddingMorpher.create(5, d_in, kappa, d_out=d_out,
                                       core_mode=mode)
    got = tlm.EmbeddingMorpher.create(5, d_in, kappa, d_out=d_out,
                                      core_mode=mode)
    assert got.core.matrix.tobytes() == want.core.matrix.tobytes()
    assert got.core.inverse.tobytes() == want.core.inverse.tobytes()
    assert (got.core.kappa, got.core.mode) == (kappa, mode)
    if d_out is None:
        assert got.out_perm is None and want.out_perm is None
    else:
        np.testing.assert_array_equal(got.out_perm, want.out_perm)


@pytest.mark.parametrize("kappa", [1, 2, 4])
@pytest.mark.parametrize("with_out_perm", [False, True],
                         ids=["no_out_perm", "out_perm"])
def test_fuse_aug_projection_matches_reference(rng, kappa, with_out_perm):
    """AugProj = M^-1 W_in (P_out) against the reference's jnp fusion at
    1e-5 x max; and the unfuse property morph(x) @ AugProj ==
    (x @ W_in)[..., perm] against float64."""
    d_in, d_out = 16, 12
    em_j = jlm.EmbeddingMorpher.create(
        9, d_in, kappa, d_out=d_out if with_out_perm else None)
    em_t = tlm.EmbeddingMorpher.create(
        9, d_in, kappa, d_out=d_out if with_out_perm else None)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    want = np.asarray(jlm.fuse_aug_projection(jax.numpy.asarray(w), em_j))
    got = tlm.fuse_aug_projection(torch.from_numpy(w), em_t)
    assert got.dtype == torch.float32
    _hold(got.numpy(), want)
    x = rng.standard_normal((3, 5, d_in)).astype(np.float32)
    delivered = torch.matmul(em_t.morph_features(torch.from_numpy(x)), got)
    plain = x.astype(np.float64) @ w.astype(np.float64)
    if with_out_perm:
        plain = plain[..., em_t.out_perm]
    _hold(delivered.numpy(), plain)


def test_registry_embed_lane_matches_reference(rng):
    """The same tenants in both registries: cores byte-equal (domain-
    separated seed), fused projections at 1e-5 x max, token permutations
    byte-equal, and the stacked views, free slots included, matching."""
    jreg, treg, _ = _lm_registries(rng, tenants=3, capacity=5)
    assert treg.has_embed_lane and jreg.has_embed_lane
    for t in ("lm0", "lm1", "lm2"):
        js, ts = jreg.session(t), treg.session(t)
        assert (ts.embed_morpher.core.matrix.tobytes()
                == js.embed_morpher.core.matrix.tobytes())
        assert (ts.embed_morpher.core.inverse.tobytes()
                == js.embed_morpher.core.inverse.tobytes())
        assert ts.embed_morpher.out_perm is None
        np.testing.assert_array_equal(ts.morpher.perm, js.morpher.perm)
        _hold(ts.aug_projection, js.aug_projection)
        assert ts.aug_projection.dtype == np.float32
    assert treg._slot_tenant == jreg._slot_tenant
    cores = treg.stacked_embed_cores()
    assert cores.shape == (5, D_IN // 2, D_IN // 2)
    assert cores.tobytes() == jreg.stacked_embed_cores().tobytes()
    assert not cores[3:].any()                       # free slots are zeros
    projs = treg.stacked_aug_projections()
    assert projs.shape == (5, D_IN, D_OUT) and not projs[3:].any()
    _hold(projs, jreg.stacked_aug_projections())
    np.testing.assert_array_equal(treg.stacked_perms(), jreg.stacked_perms())


def test_batched_gathers_match_reference(rng):
    """``ops.token_morph_batched`` / ``aug_embed_batched`` (one table per
    group) against the reference's: gathers, so exact."""
    import repro.kernels.ops as jops
    from repro_torch.kernels import aug_embed_batched, token_morph_batched

    perms = np.stack([rng.permutation(VOCAB) for _ in range(3)]).astype(
        np.int32)
    tables = rng.standard_normal((3, VOCAB, D)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (3, 2, 5)).astype(np.int32)
    morphed = token_morph_batched(torch.from_numpy(toks),
                                  torch.from_numpy(perms))
    want = np.asarray(jops.token_morph_batched(toks, perms, backend="jnp"))
    np.testing.assert_array_equal(morphed.numpy(), want)
    feats = aug_embed_batched(morphed, torch.from_numpy(tables))
    np.testing.assert_array_equal(
        feats.numpy(),
        np.asarray(jops.aug_embed_batched(want, tables, backend="jnp")))


# ---------------------------------------------------------------------------
# the engine's features lane against the reference engine
# ---------------------------------------------------------------------------

def _traffic(rng, plan):
    """plan: [(tenant, shape or "tokens", priority)] -> request pairs."""
    out = []
    for tenant, shape, prio in plan:
        if shape == "tokens":
            toks = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
            kw = dict(lane="tokens", deliver="embed", priority=prio)
            payload = toks
        else:
            payload = rng.standard_normal(shape).astype(np.float32)
            kw = dict(lane="features", priority=prio)
        out.append((jrt.DeliveryRequest(tenant, payload, **kw),
                    trt.DeliveryRequest(tenant, payload, **kw)))
    return out


def _flush_both(jeng, teng):
    """Phase-split flushes in lockstep: the same microbatches (lane, slot
    indices, padded rows, slices) round by round."""
    lanes = []
    while True:
        jw, tw = jeng.begin_flush(), teng.begin_flush()
        assert (jw is None) == (tw is None)
        if jw is None:
            return lanes
        assert [i.lane for i in tw.items] == [i.lane for i in jw.items]
        for ji, ti in zip(jw.items, tw.items):
            np.testing.assert_array_equal(ti.mb.group_tenant,
                                          ji.mb.group_tenant)
            np.testing.assert_array_equal(ti.mb.x, ji.mb.x)
            assert [dataclasses.astuple(s) for s in ti.mb.slices] == [
                dataclasses.astuple(s) for s in ji.mb.slices]
            lanes.append((ti.lane, tuple(ti.mb.group_tenant)))
        jeng.execute_flush(jw)
        teng.execute_flush(tw)
        assert sorted(jeng.publish_flush(jw)) == sorted(teng.publish_flush(tw))


def _results_match(jeng, teng, rids):
    for rid in rids:
        jr, tr = jeng.take_result(rid), teng.take_result(rid)
        assert (tr.tenant_id, tr.lane, tr.deliver) == (
            jr.tenant_id, jr.lane, jr.deliver)
        _hold(tr.payload, jr.payload)


@pytest.mark.parametrize("capacity", [None, 2])
def test_features_lane_matches_reference_engine(rng, capacity):
    """Rank-2 and rank-3 features from several tenants, out of slot order
    and from part of the table (gidx != arange), mixed with token requests
    in one flush: the same microbatches as the reference engine and
    features within 1e-5 x max.  At capacity 2 slots are evicted inside a
    flush round (copy-on-write of the embedding-core and projection
    stacks).  On the CPU no kernel is launched."""
    jreg, treg, _ = _lm_registries(rng, tenants=4, capacity=capacity)
    jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp", **SMALL)
    teng = trt.MoLeDeliveryEngine(lm_registry=treg, device="cpu", **SMALL)
    reqs = _traffic(rng, [
        ("lm3", (2, 3, D_IN), 0), ("lm1", (5, D_IN), 1), ("lm3", "tokens", 0),
        ("lm1", (1, 7, D_IN), 0), ("lm2", (3, D_IN), 0), ("lm0", "tokens", 1),
        ("lm3", (9, D_IN), 0),
    ])
    before = (grouped_block_diag_matmul.launches, grouped_aug_gemm.launches)
    rids = [jeng.submit(j) for j, _ in reqs]
    assert [teng.submit(t) for _, t in reqs] == rids
    lanes = _flush_both(jeng, teng)
    assert {lane for lane, _ in lanes} == {"features", "tokens"}
    feats = [g for lane, g in lanes if lane == "features"]
    assert any(g != tuple(range(len(g))) for g in feats)
    _results_match(jeng, teng, rids)
    assert (grouped_block_diag_matmul.launches,
            grouped_aug_gemm.launches) == before
    assert teng.stats.rows_in == jeng.stats.rows_in
    assert teng.stats.microbatches == jeng.stats.microbatches


def test_features_lane_unfuses_to_x_at_w_in(rng):
    """What a features request gets back is x @ W_in of its tenant (no
    output permutation in serving mode), against float64 at 1e-5 x max,
    and ``deliver_features`` (the per-request path) agrees."""
    _, treg, w_ins = _lm_registries(rng, tenants=3, kappa=1)
    eng = trt.MoLeDeliveryEngine(lm_registry=treg, device="cpu", **SMALL)
    for tenant, shape in [("lm0", (2, 6, D_IN)), ("lm2", (11, D_IN))]:
        x = rng.standard_normal(shape).astype(np.float32)
        got = eng.deliver(trt.DeliveryRequest(tenant, x, lane="features"))
        assert got.payload.shape == shape[:-1] + (D_OUT,)
        assert got.lane == "features"
        _hold(got.payload, x.astype(np.float64) @ w_ins[tenant])
        per_request = treg.session(tenant).deliver_features(
            torch.from_numpy(x)).numpy()
        _hold(got.payload, per_request)


_BAD_FEATURES = {
    "rank1": (np.zeros(D_IN, np.float32), ValueError),
    "rank4": (np.zeros((1, 1, 2, D_IN), np.float32), ValueError),
    "last_dim": (np.zeros((2, D_IN + 1), np.float32), ValueError),
    "empty_rows": (np.zeros((0, D_IN), np.float32), ValueError),
    "empty_positions": (np.zeros((2, 0, D_IN), np.float32), ValueError),
}


@pytest.mark.parametrize("case", sorted(_BAD_FEATURES) + [
    "unknown_tenant", "no_embed_lane", "no_lm_registry", "int_payload"])
def test_features_normalizer_errors_match_reference(rng, case):
    """The features normalizer refuses what the reference's refuses, with
    the same exception type, and accepts what it accepts (an int payload
    is converted to float32)."""
    jreg, treg, _ = _lm_registries(rng, tenants=1)
    tenant = "lm0"
    payload, err = (np.ones((2, D_IN), np.int64), None)
    if case in _BAD_FEATURES:
        payload, err = _BAD_FEATURES[case]
    elif case == "unknown_tenant":
        tenant, err = "nobody", KeyError
    elif case in ("no_embed_lane", "no_lm_registry"):
        err = ValueError
        if case == "no_embed_lane":
            jreg = jlm.LMSessionRegistry(VOCAB, D)
            treg = tlm.LMSessionRegistry(VOCAB, D)
            emb = rng.standard_normal((VOCAB, D)).astype(np.float32)
            jreg.register(tenant, emb, seed=1)
            treg.register(tenant, emb, seed=1)
    if case == "no_lm_registry":
        geom = (2, 4, 6, 3)
        jv = jcore.SessionRegistry(jcore.ConvGeometry(*geom), kappa=1)
        tv = tcore.SessionRegistry(tcore.ConvGeometry(*geom), kappa=1)
        k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
        jv.register(tenant, k, seed=2)
        tv.register(tenant, k, seed=2)
        jeng = jrt.MoLeDeliveryEngine(jv, backend="jnp")
        teng = trt.MoLeDeliveryEngine(tv, "cpu")
    else:
        jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp")
        teng = trt.MoLeDeliveryEngine(lm_registry=treg, device="cpu")
    jq = jrt.DeliveryRequest(tenant, payload, lane="features")
    tq = trt.DeliveryRequest(tenant, payload, lane="features")
    if err is None:
        got = teng.deliver(tq).payload
        assert got.dtype == np.float32
        _hold(got, np.asarray(jeng.deliver(jq).payload))
        return
    with pytest.raises(err):
        jeng.submit(jq)
    with pytest.raises(err):
        teng.submit(tq)
    assert teng.pending_rows == 0


# ---------------------------------------------------------------------------
# snapshots across packages
# ---------------------------------------------------------------------------

def test_reference_snapshot_delivers_the_same_features(rng):
    """A reference registry's ``snapshot_state()`` restored into the port's
    registry holds byte-equal secrets (the fused projections too, since
    they are carried over) and delivers the reference's features; a
    reference engine's snapshot with pending features requests restores
    into a port engine, which delivers each pending id once with the
    reference's results; the port's own snapshot round-trips."""
    jreg, _, _ = _lm_registries(rng, tenants=3, capacity=2)
    treg = tlm.LMSessionRegistry(VOCAB, D, d_in=D_IN, d_out=D_OUT, kappa=2,
                                 capacity=2)
    treg.restore_state(*jreg.snapshot_state())
    x = rng.standard_normal((2, 4, D_IN)).astype(np.float32)
    for t in ("lm0", "lm1", "lm2"):
        js, ts = jreg.session(t), treg.session(t)
        assert ts.aug_projection.tobytes() == js.aug_projection.tobytes()
        assert (ts.embed_morpher.core.matrix.tobytes()
                == js.embed_morpher.core.matrix.tobytes())
        _hold(ts.deliver_features(torch.from_numpy(x)).numpy(),
              np.asarray(js.deliver_features(jax.numpy.asarray(x))))

    jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp", **SMALL)
    reqs = _traffic(rng, [("lm2", (3, D_IN), 0), ("lm0", (1, 5, D_IN), 0),
                          ("lm1", "tokens", 0), ("lm2", (2, 2, D_IN), 1)])
    rids = [jeng.submit(j) for j, _ in reqs]
    snap = jeng.snapshot()
    teng = trt.MoLeDeliveryEngine(
        lm_registry=tlm.LMSessionRegistry(VOCAB, D, d_in=D_IN, d_out=D_OUT,
                                          kappa=2, capacity=2),
        device="cpu", **SMALL)
    assert teng.restore(snap) == rids
    jeng.restore(snap)
    _flush_both(jeng, teng)
    _results_match(jeng, teng, rids)

    more = _traffic(rng, [("lm1", (2, 3, D_IN), 0), ("lm0", (4, D_IN), 0)])
    rids = [teng.submit(t) for _, t in more]
    again = trt.MoLeDeliveryEngine(
        lm_registry=tlm.LMSessionRegistry(VOCAB, D, d_in=D_IN, d_out=D_OUT,
                                          kappa=2, capacity=2),
        device="cpu", **SMALL)
    assert again.restore(teng.snapshot()) == rids
    again.flush()
    for rid, (_, tq) in zip(rids, more):
        want = teng.lm_registry.session(tq.tenant_id).deliver_features(
            torch.from_numpy(tq.payload)).numpy()
        _hold(again.take(rid), want)


def test_restore_refuses_registry_with_other_d_in(rng):
    """A snapshot of an engine with pending features requests does not
    restore into an engine whose LM registry has another ``d_in`` (or no
    continuous lane), whichever package took it."""
    jreg, treg, _ = _lm_registries(rng, tenants=2)
    x = rng.standard_normal((1, 3, D_IN)).astype(np.float32)
    jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp")
    teng = trt.MoLeDeliveryEngine(lm_registry=treg, device="cpu")
    jeng.submit(jrt.DeliveryRequest("lm0", x, lane="features"))
    teng.submit(trt.DeliveryRequest("lm0", x, lane="features"))
    for snap in (jeng.snapshot(), teng.snapshot()):
        for reg in (
            tlm.LMSessionRegistry(VOCAB, D, d_in=2 * D_IN, d_out=D_OUT,
                                  kappa=2),
            tlm.LMSessionRegistry(VOCAB, D),
        ):
            fresh = trt.MoLeDeliveryEngine(lm_registry=reg, device="cpu")
            with pytest.raises(ValueError, match="config mismatch"):
                fresh.restore(snap)


# ---------------------------------------------------------------------------
# core.deploy
# ---------------------------------------------------------------------------

def _port_cfg(jcfg, **change):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**dict(fields, **change))


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("arch,tie", [
    ("deepseek_7b", False), ("deepseek_7b", True),
    ("llama32_vision_90b", False), ("whisper_tiny", False),
])
def test_fuse_lm_params_matches_reference(arch, tie):
    """``fuse_lm_params`` on the reference's smoke parameter dicts (as
    tensors), with a token morpher and an embedding morpher of the same
    seeds: the embedding and the untied head fused exactly as the
    reference's (gathers), the frontend / audio encoder projection at 1e-5 x
    max, and every other entry passed through untouched."""
    jcfg = dataclasses.replace(j_smoke(arch), tie_embeddings=tie)
    params = JModel(jcfg).init(jax.random.key(0))
    tparams = _to_torch(params)
    d_in = jcfg.frontend.d_in if jcfg.frontend is not None else 16
    jtm, ttm = (m.TokenMorpher.create(3, jcfg.vocab) for m in (jlm, tlm))
    jem, tem = (m.EmbeddingMorpher.create(4, d_in, 2) for m in (jlm, tlm))
    want = j_fuse_lm_params(params, jcfg, token_morpher=jtm, embed_morpher=jem)
    got = fuse_lm_params(tparams, _port_cfg(jcfg), token_morpher=ttm,
                         embed_morpher=tem)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    src_flat = dict(jax.tree_util.tree_flatten_with_path(tparams)[0])
    assert sorted(map(str, got_flat)) == sorted(str(p) for p, _ in want_flat)
    fused = set()
    for path, w in want_flat:
        g = got_flat[path]
        w = np.asarray(w)
        name = jax.tree_util.keystr(path)
        if "proj" in name:
            _hold(g.numpy(), w)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
        if g is not src_flat[path]:
            fused.add(name)
    if jcfg.family == "audio":
        expect = {"['dec']['embed']", "['dec']['head']", "['enc_proj']"}
    else:
        expect = {"['embed']"} | (set() if tie else {"['head']"})
        if jcfg.frontend is not None:
            expect.add("['frontend_proj']")
    assert fused == expect
    # Token morphing alone leaves the projection untouched, and vice versa.
    only_tok = fuse_lm_params(tparams, _port_cfg(jcfg), token_morpher=ttm)
    for key in ("frontend_proj", "enc_proj"):
        if key in tparams:
            assert only_tok[key] is tparams[key]
