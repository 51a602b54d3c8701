"""PyTorch port of the MoLe core (``repro_torch.core``) against the JAX
reference (``repro.core``) on the same numpy inputs and the same seeds.

Secrets and the d2r matrix are built by the same numpy code in both
packages, so they must be byte-equal.  ``build_aug_conv`` fuses with a
float64 matmul where the reference uses ``np.einsum``: same function,
another summation order, held at rtol 1e-6 after the fp32 cast.  Delivery
through ``MoLeSession.deliver`` is held at 1e-5, the reference's own bound.
"""
import importlib
import os
import pkgutil
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.core as tcore  # noqa: E402

GEOMS = [(2, 4, 6, 3), (3, 16, 8, 3)]


def _pair(alpha, beta, m, p, **kw):
    return jcore.ConvGeometry(alpha, beta, m, p, **kw), tcore.ConvGeometry(
        alpha, beta, m, p, **kw
    )


@pytest.mark.parametrize("shape", GEOMS)
@pytest.mark.parametrize("stride,padding", [(1, None), (2, 0), (2, 1)])
def test_conv_as_matrix_byte_equal(rng, shape, stride, padding):
    jg, tg = _pair(*shape, stride=stride, padding=padding)
    assert (jg.n, jg.in_features, jg.out_features) == (
        tg.n, tg.in_features, tg.out_features
    )
    k = rng.standard_normal((shape[0], shape[1], shape[3], shape[3])).astype(
        np.float32
    )
    want = jcore.conv_as_matrix(k, jg)
    got = tcore.conv_as_matrix(k, tg)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", GEOMS)
def test_unroll_reroll_byte_equal(rng, shape):
    jg, tg = _pair(*shape)
    d = rng.standard_normal((3, jg.alpha, jg.m, jg.m)).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.unroll_batch(torch.from_numpy(d)).numpy(),
        np.asarray(jcore.unroll_batch(jnp.asarray(d))),
    )
    np.testing.assert_array_equal(
        tcore.unroll(torch.from_numpy(d[0])).numpy(),
        np.asarray(jcore.unroll(jnp.asarray(d[0]))),
    )
    fr = rng.standard_normal((3, tg.out_features)).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.reroll_batch(torch.from_numpy(fr), tg.beta, tg.n).numpy(),
        np.asarray(jcore.reroll_batch(jnp.asarray(fr), jg.beta, jg.n)),
    )


@pytest.mark.parametrize("shape", GEOMS)
@pytest.mark.parametrize("stride,padding", [(1, None), (2, 1)])
def test_conv_reference_matches(rng, shape, stride, padding):
    jg, tg = _pair(*shape, stride=stride, padding=padding)
    k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(np.float32)
    d = rng.standard_normal((2, jg.alpha, jg.m, jg.m)).astype(np.float32)
    want = np.asarray(jcore.conv_reference(jnp.asarray(d), jnp.asarray(k), jg))
    got = tcore.conv_reference(torch.from_numpy(d), torch.from_numpy(k), tg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # and the d2r identity holds in the port
    C = torch.from_numpy(tcore.conv_as_matrix(k, tg))
    np.testing.assert_allclose(
        tcore.d2r_conv_apply(torch.from_numpy(d), C, tg).numpy(), want,
        atol=1e-4,
    )


@pytest.mark.parametrize("mode", ["orthogonal", "uniform"])
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("n_features,kappa", [(72, 1), (72, 4), (192, 2)])
def test_make_core_byte_equal(mode, seed, n_features, kappa):
    want = jcore.make_core(seed, n_features, kappa, mode=mode)
    got = tcore.make_core(seed, n_features, kappa, mode=mode)
    assert got.matrix.tobytes() == want.matrix.tobytes()
    assert got.inverse.tobytes() == want.inverse.tobytes()
    assert (got.kappa, got.mode, got.q) == (want.kappa, want.mode, want.q)
    assert repr(got) == repr(want)
    np.testing.assert_array_equal(
        tcore.materialize_M(got), jcore.materialize_M(want)
    )


@pytest.mark.parametrize("kappa", [1, 2, 4])
def test_morph_unmorph_match(rng, kappa):
    jc, tc = jcore.make_core(3, 72, kappa), tcore.make_core(3, 72, kappa)
    x = rng.standard_normal((5, 72)).astype(np.float32)
    want = np.asarray(jcore.morph(jnp.asarray(x), jc))
    got = tcore.morph(torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    back = tcore.unmorph(got, tc)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jcore.unmorph(jnp.asarray(want), jc)),
        atol=1e-5,
    )
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("shape", GEOMS)
@pytest.mark.parametrize("kappa", [1, 2])
@pytest.mark.parametrize("mode", ["orthogonal", "uniform"])
def test_build_aug_conv_matches_einsum_fusion(rng, shape, kappa, mode):
    """Float64 BLAS fusion vs the reference's einsum: rtol 1e-6 after the
    fp32 cast; the permutation is byte-equal."""
    jg, tg = _pair(*shape)
    k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(np.float32)
    core = jcore.make_core(11, jg.in_features, kappa, mode=mode)
    want = jcore.build_aug_conv(k, jg, core, perm_seed=5)
    got = tcore.build_aug_conv(k, tg, core, perm_seed=5)
    np.testing.assert_array_equal(got.channel_perm, want.channel_perm)
    assert got.matrix.dtype == want.matrix.dtype
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tcore.permute_channel_groups(want.matrix, want.channel_perm, jg.n),
        jcore.permute_channel_groups(want.matrix, want.channel_perm, jg.n),
    )


def test_build_aug_conv_rejects_mismatched_core(rng):
    _, tg = _pair(2, 4, 6, 3)
    k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        tcore.build_aug_conv(k, tg, tcore.make_core(0, 16, 1))


@pytest.mark.parametrize("shape", GEOMS)
@pytest.mark.parametrize("kappa", [1, 2])
def test_session_deliver_matches_reference(rng, shape, kappa):
    """Same seed -> same secrets -> MoLeSession.deliver within 1e-5, and the
    port's delivery is the plain conv under the secret permutation (eq. 5)."""
    jg, tg = _pair(*shape)
    k = rng.standard_normal((jg.alpha, jg.beta, jg.p, jg.p)).astype(np.float32)
    d = rng.standard_normal((3, jg.alpha, jg.m, jg.m)).astype(np.float32)
    js = jcore.MoLeSession.create(k, jg, kappa=kappa, seed=9)
    ts = tcore.MoLeSession.create(k, tg, kappa=kappa, seed=9)
    assert ts.provider._perm.tobytes() == js.provider._perm.tobytes()
    want = np.asarray(js.deliver(jnp.asarray(d)))
    got = ts.deliver(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    conv = tcore.conv_reference(torch.from_numpy(d), torch.from_numpy(k), tg)
    np.testing.assert_allclose(
        got, conv.numpy()[:, ts.provider._perm], atol=5e-3
    )
    np.testing.assert_allclose(
        ts.provider.unmorph_rows(ts.provider.morph_batch(torch.from_numpy(d)))
        .numpy(), d.reshape(3, -1), atol=1e-5,
    )
    assert ts.provider.morphed_image(torch.from_numpy(d)).shape == d.shape


def test_security_and_overhead_match(rng):
    jg, tg = _pair(3, 16, 8, 3)
    jp = jcore.DataProvider(jg, kappa=1, seed=0)
    tp = tcore.DataProvider(tg, kappa=1, seed=0)
    assert asdict(tp.security(0.5)) == asdict(jp.security(0.5))
    assert asdict(tp.overhead(10**9, 50_000)) == asdict(jp.overhead(10**9, 50_000))


@pytest.mark.parametrize("capacity", [None, 2])
def test_registry_restore_state_carries_secrets_byte_equal(rng, capacity):
    """A reference registry's snapshot loads into the port's registry: same
    slots, LRU state and changelog, byte-equal stacked secrets."""
    jg, tg = _pair(2, 4, 6, 3)
    jreg = jcore.SessionRegistry(jg, kappa=2, capacity=capacity)
    for i in range(4):
        k = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
        jreg.register(f"t{i}", k, seed=i, weight=1.0 + i)
    treg = tcore.SessionRegistry(tg, kappa=2, capacity=capacity)
    meta, arrays = jreg.snapshot_state()
    treg.restore_state(meta, arrays)
    assert treg.tenant_ids == jreg.tenant_ids
    assert treg.resident_tenants == jreg.resident_tenants
    assert (treg.version, treg.evictions, treg.capacity) == (
        jreg.version, jreg.evictions, jreg.capacity
    )
    assert treg.updates_since(0) == jreg.updates_since(0)
    assert [treg.weight_of(t) for t in treg.tenant_ids] == [
        jreg.weight_of(t) for t in jreg.tenant_ids
    ]
    assert treg.stacked_cores().tobytes() == jreg.stacked_cores().tobytes()
    assert (treg.stacked_aug_matrices().tobytes()
            == jreg.stacked_aug_matrices().tobytes())
    # and back: the port's snapshot loads into a fresh reference registry
    back = jcore.SessionRegistry(jg, kappa=2, capacity=capacity)
    back.restore_state(*treg.snapshot_state())
    assert back.stacked_cores().tobytes() == jreg.stacked_cores().tobytes()
    # the same slot churn follows from the same lookups
    for t in ("t0", "t3", "t1"):
        assert treg.slot_for(t) == jreg.slot_for(t)
    assert treg.resident_tenants == jreg.resident_tenants
    assert treg.stacked_cores().tobytes() == jreg.stacked_cores().tobytes()
    assert "t0" in treg and len(treg) == 4


def test_registry_register_matches_reference(rng):
    """register() with explicit seeds draws the reference's secrets."""
    jg, tg = _pair(3, 16, 8, 3)
    jreg = jcore.SessionRegistry(jg, kappa=1, capacity=3)
    treg = tcore.SessionRegistry(tg, kappa=1, capacity=3)
    for i in range(5):
        k = rng.standard_normal((3, 16, 3, 3)).astype(np.float32)
        jreg.register(f"t{i}", k, seed=40 + i)
        treg.register(f"t{i}", k, seed=40 + i)
    assert treg.resident_tenants == jreg.resident_tenants
    assert treg.stacked_cores().tobytes() == jreg.stacked_cores().tobytes()
    np.testing.assert_allclose(
        treg.stacked_aug_matrices(), jreg.stacked_aug_matrices(),
        rtol=1e-6, atol=1e-7,
    )
    with pytest.raises(ValueError):
        treg.register("t0", k)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, prefix="repro_torch."
        )
    )


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port leaves jax and repro out of
    sys.modules (checked in a fresh interpreter)."""
    mods = _port_modules()
    assert "repro_torch.runtime.engine" in mods
    assert "repro_torch.launch.serve" in mods
    assert {"repro_torch.runtime.decode", "repro_torch.models.api",
            "repro_torch.core.lm", "repro_torch.launch.steps"} <= set(mods)
    assert {"repro_torch.kernels.block_diag", "repro_torch.kernels.aug_gemm",
            "repro_torch.kernels.gemm", "repro_torch.models.cnn"} <= set(mods)
    assert {"repro_torch.kernels.wkv6", "repro_torch.configs.rwkv6_3b"} <= set(mods)
    assert "repro_torch.configs.phi3_mini_3p8b" in mods
    assert {"repro_torch.configs.command_r_35b",
            "repro_torch.configs.gemma2_27b"} <= set(mods)
    assert {"repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.deepseek_v2_lite_16b"} <= set(mods)
    assert {"repro_torch.configs.recurrentgemma_2b",
            "repro_torch.configs.llama32_vision_90b"} <= set(mods)
    assert {"repro_torch.models.whisper",
            "repro_torch.configs.whisper_tiny"} <= set(mods)
    assert {"repro_torch.checkpoint.manager", "repro_torch.runtime.async_engine",
            "repro_torch.runtime.wire", "repro_torch.launch.server",
            "repro_torch.launch.client"} <= set(mods)
    assert "repro_torch.core.deploy" in mods
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline"} <= set(mods)
    assert {"repro_torch.launch.train", "repro_torch.optim.compress",
            "repro_torch.runtime.resilience"} <= set(mods)
    assert {"repro_torch.sharding", "repro_torch.sharding.rules",
            "repro_torch.sharding.hints", "repro_torch.sharding.spmd",
            "repro_torch.launch.mesh"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    src = str(importlib.import_module("repro_torch").__path__[0]).rsplit(
        "/repro_torch", 1
    )[0]
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=src), timeout=120,
    )
    assert out.returncode == 0, out.stderr
