"""The port's LM delivery pieces on the CPU against the JAX reference:
K3's plain version (``grouped_row_gemm`` / ``lm_head_rows_grouped``, on
fp32 and bf16 tables), the
LM gathers, ``core.lm`` (secrets byte-equal through ``snapshot_state`` /
``restore_state``), and the engine's token lane against
``MoLeDeliveryEngine(lm_registry=...)``.

Tolerances: the token lane and the gathers are exact (gathers move bits).
K3 in fp32: ``|port - ref| <= 1e-5 * max|ref|`` (sums in another order).
K3 in bf16: one bf16 unit in the last place of ``max|ref|`` (2**-7 of its
power of two): both sides accumulate in fp32 and round once to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.lm as jlm  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
import repro.runtime as jrt  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.kernels as tk  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402

GIDX_CASES = {      # over a 6-slot table, as in tests/test_grouped_kernels.py
    "identity": [0, 1, 2, 3],
    "partial_table": [0, 1, 2, 4],
    "out_of_order": [4, 0, 5, 2],
    "duplicates": [3, 3, 1, 3],
    "out_of_range": [1, 9, -2, 5],
}
R, K, N, S = 4, 512, 256, 6
VOCAB, D = 64, 16
SMALL = dict(max_rows=8, row_buckets=(1, 2, 4, 8), group_buckets=(1, 2, 4),
             seq_buckets=(4, 8, 16))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _k3_inputs(rng, bf16_tables=False):
    h = rng.standard_normal((R, K)).astype(np.float32)
    tables = (rng.standard_normal((S, K, N)) * K ** -0.5).astype(np.float32)
    if bf16_tables:
        tables = torch.from_numpy(tables).bfloat16().float().numpy()
    return h, tables


def _hold_k3(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.abs(want).max())
    bound = 1e-5 * scale if dtype == "float32" else _bf16_ulp(scale)
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GIDX_CASES))
def test_k3_plain_matches_reference_ref(rng, case, dtype):
    """``grouped_row_gemm`` on CPU tensors (its plain version) against
    ``repro.kernels.ref.lm_head_rows_grouped_ref`` (contraction in h.dtype)
    and the port's ops entry point against the reference's jnp backend."""
    h, tables = _k3_inputs(rng)
    gidx = np.asarray(GIDX_CASES[case], np.int32)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    jh = jnp.asarray(h, getattr(jnp, dtype))
    safe = np.clip(gidx, 0, S - 1)
    want = jref.lm_head_rows_grouped_ref(jh, jnp.asarray(safe),
                                         jnp.asarray(tables))
    before = tk.grouped_row_gemm.launches
    got = tk.grouped_row_gemm(th, torch.from_numpy(safe),
                              torch.from_numpy(tables))
    assert got.dtype == th.dtype and got.shape == (R, N)
    _hold_k3(got, want, dtype)
    got = tk.lm_head_rows_grouped(th, gidx, torch.from_numpy(tables))
    _hold_k3(got, jops.lm_head_rows_grouped(
        jh, jnp.asarray(gidx), jnp.asarray(tables), backend="jnp"), dtype)
    assert tk.grouped_row_gemm.launches == before   # CPU: no kernel launch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GIDX_CASES))
def test_k3_plain_matches_pallas_interpret(rng, case, dtype):
    """Against the Pallas kernel itself (interpret mode).  The Pallas kernel
    promotes a bf16 ``h`` against fp32 tables and so skips the rounding of
    the table to bf16; the tables here hold bf16-representable values (as
    the decode lane's do: fused from a bf16 head), where the rounding is
    exact and both semantics agree."""
    h, tables = _k3_inputs(rng, bf16_tables=True)
    gidx = np.asarray(GIDX_CASES[case], np.int32)
    want = jops.lm_head_rows_grouped(
        jnp.asarray(h, getattr(jnp, dtype)), jnp.asarray(gidx),
        jnp.asarray(tables), backend="interpret",
    )
    got = tk.lm_head_rows_grouped(
        torch.from_numpy(h).to(getattr(torch, dtype)), gidx,
        torch.from_numpy(tables),
    )
    _hold_k3(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GIDX_CASES))
def test_k3_plain_bf16_tables_match_reference_ref(rng, case, dtype):
    """bf16 tables, the decode lane's head stacks in a bf16 model: the
    plain version on the tables rounded to bf16 against the reference's
    ``lm_head_rows_grouped_ref`` on the same values in fp32, for both h
    dtypes; and bit for bit what the port gives on those values held in
    fp32 (a bf16 entry is exact in fp32)."""
    h, tables = _k3_inputs(rng)
    t16 = torch.from_numpy(tables).bfloat16()
    rounded = t16.float()
    gidx = np.asarray(GIDX_CASES[case], np.int32)
    safe = np.clip(gidx, 0, S - 1)
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    want = jref.lm_head_rows_grouped_ref(jnp.asarray(h, getattr(jnp, dtype)),
                                         jnp.asarray(safe),
                                         jnp.asarray(rounded.numpy()))
    before = tk.grouped_row_gemm.launches
    got = tk.grouped_row_gemm(th, torch.from_numpy(safe), t16)
    assert got.dtype == th.dtype and got.shape == (R, N)
    _hold_k3(got, want, dtype)
    assert torch.equal(got, tk.grouped_row_gemm(th, torch.from_numpy(safe),
                                                rounded))
    assert torch.equal(tk.lm_head_rows_grouped(th, gidx, t16),
                       tk.lm_head_rows_grouped(th, gidx, rounded))
    assert tk.grouped_row_gemm.launches == before   # CPU: no kernel launch


def test_k3_wrapper_validates(rng):
    h, tables = _k3_inputs(rng)
    th, tt = torch.from_numpy(h), torch.from_numpy(tables)
    g = torch.zeros(R, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 gidx"):
        tk.grouped_row_gemm(th, g.long(), tt)
    with pytest.raises(TypeError, match="float32 or bfloat16 tables"):
        tk.grouped_row_gemm(th, g, tt.double())
    with pytest.raises(TypeError, match="float32 or bfloat16 tables"):
        tk.grouped_row_gemm(th, g, tt.half())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.grouped_row_gemm(th.half(), g, tt)
    with pytest.raises(ValueError, match=r"\(R, K\)"):
        tk.grouped_row_gemm(th[:, :-1], g, tt)
    with pytest.raises(ValueError, match="contiguous"):
        tk.grouped_row_gemm(th, g, tt.transpose(1, 2).contiguous().transpose(1, 2))
    # Ragged shapes run the same path (the kernel masks every edge).
    out = tk.grouped_row_gemm(th[:3, :300].contiguous(), g[:3],
                              tt[:, :300, :100].contiguous())
    assert out.shape == (3, 100)


def test_lm_gathers_match_reference(rng):
    """Token morph, Aug-Embedding and the per-row AugE gather: byte-equal to
    the reference's ops for every slot pattern (incl. clamp)."""
    perms = np.stack([rng.permutation(VOCAB) for _ in range(S)]).astype(np.int32)
    tables = rng.standard_normal((S, VOCAB, D)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, (4, 3, 5)).astype(np.int32)
    for idx in GIDX_CASES.values():
        gidx = np.asarray(idx, np.int32)
        tm = tk.token_morph_grouped(torch.from_numpy(tokens), gidx,
                                    torch.from_numpy(perms))
        jm = jops.token_morph_grouped(jnp.asarray(tokens), jnp.asarray(gidx),
                                      jnp.asarray(perms), backend="jnp")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        te = tk.aug_embed_grouped(tm, gidx, torch.from_numpy(tables))
        je = jops.aug_embed_grouped(jm, jnp.asarray(gidx),
                                    jnp.asarray(tables), backend="jnp")
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        tr = tk.aug_embed_rows_grouped(tm[:, 0, 0], gidx,
                                       torch.from_numpy(tables))
        jr = jops.aug_embed_rows_grouped(jm[:, 0, 0], jnp.asarray(gidx),
                                         jnp.asarray(tables), backend="jnp")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # The one-table-per-group (-row) plain versions.
    tp, tt = torch.from_numpy(perms[:4]), torch.from_numpy(tables[:4])
    tt_ = torch.from_numpy(tokens)
    np.testing.assert_array_equal(
        tk.ref.token_morph_batched_ref(tt_, tp).numpy(),
        np.asarray(jref.token_morph_batched_ref(jnp.asarray(tokens),
                                                jnp.asarray(perms[:4]))))
    np.testing.assert_array_equal(
        tk.ref.aug_embed_batched_ref(tt_, tt).numpy(),
        np.asarray(jref.aug_embed_batched_ref(jnp.asarray(tokens),
                                              jnp.asarray(tables[:4]))))
    np.testing.assert_array_equal(
        tk.ref.aug_embed_rows_batched_ref(tt_[:, 0, 0], tt).numpy(),
        np.asarray(jref.aug_embed_rows_batched_ref(
            jnp.asarray(tokens[:, 0, 0]), jnp.asarray(tables[:4]))))
    h = rng.standard_normal((4, D)).astype(np.float32)
    heads = rng.standard_normal((4, D, VOCAB)).astype(np.float32)
    got = tk.ref.lm_head_rows_batched_ref(torch.from_numpy(h),
                                          torch.from_numpy(heads))
    _hold_k3(got, jref.lm_head_rows_batched_ref(jnp.asarray(h),
                                                jnp.asarray(heads)), "float32")


def _lm_registries(rng, tenants=3, capacity=None, head=True):
    embed = rng.standard_normal((VOCAB, D)).astype(np.float32)
    hd = rng.standard_normal((D, VOCAB)).astype(np.float32) if head else None
    jreg = jlm.LMSessionRegistry(VOCAB, D, capacity=capacity)
    for i in range(tenants):
        jreg.register(f"lm{i}", embed, seed=50 + i, head=hd)
    treg = tlm.LMSessionRegistry(VOCAB, D, capacity=capacity)
    treg.restore_state(*jreg.snapshot_state())
    return jreg, treg


@pytest.mark.parametrize("head", [True, False])
def test_lm_registry_secrets_byte_equal(rng, head):
    jreg, treg = _lm_registries(rng, capacity=2, head=head)
    for t in ("lm0", "lm1", "lm2"):
        js, ts = jreg.session(t), treg.session(t)
        np.testing.assert_array_equal(ts.morpher.perm, js.morpher.perm)
        np.testing.assert_array_equal(ts.morpher.inv_perm, js.morpher.inv_perm)
        np.testing.assert_array_equal(ts.aug_embedding, js.aug_embedding)
        np.testing.assert_array_equal(ts.aug_head, js.aug_head)
    np.testing.assert_array_equal(treg.stacked_perms(), jreg.stacked_perms())
    np.testing.assert_array_equal(treg.stacked_aug_embeddings(),
                                  jreg.stacked_aug_embeddings())
    np.testing.assert_array_equal(treg.stacked_aug_heads(),
                                  jreg.stacked_aug_heads())
    # A fresh registration draws the reference's permutation from its seed.
    embed = jreg.session("lm0").embedding
    t2 = tlm.LMSessionRegistry(VOCAB, D).register("x", embed, seed=77)
    j2 = jlm.LMSessionRegistry(VOCAB, D).register("x", embed, seed=77)
    np.testing.assert_array_equal(t2.morpher.perm, j2.morpher.perm)
    # AugE[pi(v)] == E[v], through the per-request path; unmorph inverts.
    tok = torch.arange(VOCAB)
    np.testing.assert_array_equal(ts.deliver_tokens(tok).numpy(), ts.embedding)
    np.testing.assert_array_equal(
        ts.unmorph_tokens(ts.morph_tokens(tok)).numpy(), tok.numpy())


def test_lm_registry_features_lane_raises():
    """The continuous lane's configuration errors raise the reference's
    ValueErrors: d_in without d_out, a kappa that does not divide d_in,
    w_in for a registry without the lane, a missing or misshapen w_in for
    one with it."""
    with pytest.raises(ValueError, match="together"):
        tlm.LMSessionRegistry(VOCAB, D, d_in=8)
    with pytest.raises(ValueError, match="must divide"):
        tlm.LMSessionRegistry(VOCAB, D, d_in=8, d_out=8, kappa=3)
    emb = np.zeros((VOCAB, D), np.float32)
    reg = tlm.LMSessionRegistry(VOCAB, D)
    with pytest.raises(ValueError, match="no continuous lane"):
        reg.register("a", emb, w_in=np.zeros((8, 8), np.float32))
    reg = tlm.LMSessionRegistry(VOCAB, D, d_in=8, d_out=6)
    with pytest.raises(ValueError, match="pass w_in"):
        reg.register("a", emb)
    with pytest.raises(ValueError, match="expected w_in"):
        reg.register("a", emb, w_in=np.zeros((8, 8), np.float32))
    assert len(reg) == 0


def _token_traffic(rng, tenants):
    """[(tenant, tokens (b, L), deliver, priority)] with ragged lengths."""
    out = []
    for i in range(9):
        b, L = 1 + i % 3, (3, 5, 8, 11)[i % 4]
        out.append((f"lm{(i * 2) % tenants}",
                    rng.integers(0, VOCAB, (b, L)).astype(np.int32),
                    "embed" if i % 3 == 1 else "tokens", i % 2))
    return out


@pytest.mark.parametrize("capacity", [None, 2])
def test_token_lane_matches_reference_engine(rng, capacity):
    """The same token traffic through both engines: the same microbatches,
    morphed tokens byte-equal, Aug-embedded features equal (== E[tokens]).
    capacity=2 < 3 tenants evicts slots inside one flush round, so the
    port's copy-on-write of the (S, V) / (S, V, d) stacks runs."""
    jreg, treg = _lm_registries(rng, capacity=capacity)
    jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp", **SMALL)
    teng = trt.MoLeDeliveryEngine(lm_registry=treg, device="cpu", **SMALL)
    traffic = _token_traffic(rng, 3)
    pairs = []
    for tenant, toks, deliver, prio in traffic:
        kw = dict(lane="tokens", deliver=deliver, priority=prio)
        pairs.append((jeng.submit(jrt.DeliveryRequest(tenant, toks, **kw)),
                      teng.submit(trt.DeliveryRequest(tenant, toks, **kw))))
    jeng.flush()
    teng.flush()
    assert teng.stats.microbatches == jeng.stats.microbatches
    assert teng.stats.bucket_shapes == jeng.stats.bucket_shapes
    for (jr, tr), (tenant, toks, deliver, _) in zip(pairs, traffic):
        got, want = teng.take(tr), np.asarray(jeng.take(jr))
        np.testing.assert_array_equal(got, want)
        if deliver == "embed":
            np.testing.assert_array_equal(got, treg.session(tenant).embedding[toks])
        else:
            np.testing.assert_array_equal(
                got, treg.session(tenant).morpher.perm[toks])


def test_token_lane_snapshot_restore_across_packages(rng):
    """A reference engine's snapshot (LM registry + pending token requests)
    restores into the port's engine, which then delivers what the
    reference delivers."""
    jreg, treg = _lm_registries(rng)
    jeng = jrt.MoLeDeliveryEngine(lm_registry=jreg, backend="jnp", **SMALL)
    traffic = _token_traffic(rng, 3)
    rids = [jeng.submit(jrt.DeliveryRequest(t, x, lane="tokens", deliver=d,
                                            priority=p))
            for t, x, d, p in traffic]
    snap = jeng.snapshot()
    teng = trt.MoLeDeliveryEngine(
        lm_registry=tlm.LMSessionRegistry(VOCAB, D), device="cpu", **SMALL
    )
    assert teng.restore(trt.EngineSnapshot(arrays=snap.arrays,
                                           meta=snap.meta)) == rids
    jeng.flush()
    teng.flush()
    for r in rids:
        np.testing.assert_array_equal(teng.take(r), np.asarray(jeng.take(r)))
    # And the port's own image round-trips.
    r2 = teng.submit(trt.DeliveryRequest("lm1", traffic[0][1], lane="tokens"))
    snap2 = teng.snapshot()
    assert snap2.meta["registries"]["lm"] is not None
    teng.restore(snap2)
    teng.flush()
    np.testing.assert_array_equal(
        teng.take(r2), treg.session("lm1").morpher.perm[traffic[0][1]])


def test_mixed_vision_and_token_lanes(rng):
    """One engine, both registries: each lane delivers what it delivers
    alone."""
    import repro_torch.core as tcore

    geom = tcore.ConvGeometry(2, 4, 6, 3)
    vreg = tcore.SessionRegistry(geom, kappa=2)
    k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    vreg.register("v0", k, seed=1)
    _, treg = _lm_registries(rng)
    eng = trt.MoLeDeliveryEngine(vreg, "cpu", lm_registry=treg, **SMALL)
    img = rng.standard_normal((2, 2, 6, 6)).astype(np.float32)
    toks = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    rv = eng.submit(trt.DeliveryRequest("v0", img))
    rt = eng.submit(trt.DeliveryRequest("lm2", toks, lane="tokens"))
    eng.flush()
    np.testing.assert_allclose(
        eng.take(rv), vreg.session("v0").deliver(torch.from_numpy(img)).numpy(),
        atol=1e-5,
    )
    np.testing.assert_array_equal(
        eng.take(rt), treg.session("lm2").morpher.perm[toks])
    with pytest.raises(ValueError, match="no continuous lane"):
        eng.submit(trt.DeliveryRequest(
            "lm0", np.zeros((1, 4), np.float32), lane="features"))
