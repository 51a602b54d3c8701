"""The port's grouped delivery kernels (``repro_torch.kernels``) on the CPU,
against the JAX reference's grouped entry points (``repro.kernels.ops``) on
the same numpy inputs: the ``jnp`` backend at every shape, and the Pallas
kernels in interpret mode at tiny tileable shapes, as
``tests/test_grouped_kernels.py`` runs them.  Bound: atol 1e-5.

On the CPU a wrapper runs its kernel's plain version (``kernels/ref.py``);
the CUDA kernels themselves are held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    aug_conv_forward_grouped, grouped_aug_gemm, grouped_block_diag_matmul,
    morph_rows_grouped, ref,
)

# Index vectors over a 6-slot table, 4 groups (tests/test_grouped_kernels.py).
GIDX_CASES = {
    "identity": [0, 1, 2, 3],
    "partial_table": [0, 1, 2, 4],
    "out_of_order": [4, 0, 5, 2],
    "duplicates": [3, 3, 1, 3],
}
ATOL = 1e-5


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("B,kappa,q", [(8, 2, 128), (1, 3, 10), (3, 1, 24)])
def test_morph_rows_grouped_matches_reference(rng, name, B, kappa, q):
    x = _f32(rng, 4, B, kappa * q)
    cores = _f32(rng, 6, q, q, scale=q ** -0.5)
    gidx = np.array(GIDX_CASES[name], np.int32)
    want = np.asarray(jops.morph_rows_grouped(
        jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(cores), kappa,
        backend="jnp",
    ))
    got = morph_rows_grouped(_t(x), _t(gidx), _t(cores), kappa)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("B,K,N", [(8, 256, 128), (1, 600, 9), (3, 37, 50)])
def test_aug_conv_forward_grouped_matches_reference(rng, name, B, K, N):
    t = _f32(rng, 4, B, K)
    c = _f32(rng, 6, K, N, scale=K ** -0.5)
    gidx = np.array(GIDX_CASES[name], np.int32)
    want = np.asarray(jops.aug_conv_forward_grouped(
        jnp.asarray(t), jnp.asarray(gidx), jnp.asarray(c), backend="jnp",
    ))
    got = aug_conv_forward_grouped(_t(t), _t(gidx), _t(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
def test_grouped_ops_match_pallas_interpret(rng, name):
    """Against the Pallas kernels themselves (interpret mode, tileable)."""
    gidx = np.array(GIDX_CASES[name], np.int32)
    x = _f32(rng, 4, 8, 2 * 128)
    cores = _f32(rng, 6, 128, 128, scale=128 ** -0.5)
    want = np.asarray(jops.morph_rows_grouped(
        jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(cores), 2,
        backend="interpret",
    ))
    got = morph_rows_grouped(_t(x), _t(gidx), _t(cores), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    t = _f32(rng, 4, 8, 512)
    c = _f32(rng, 6, 512, 128, scale=512 ** -0.5)
    want = np.asarray(jops.aug_conv_forward_grouped(
        jnp.asarray(t), jnp.asarray(gidx), jnp.asarray(c), backend="interpret",
    ))
    got = aug_conv_forward_grouped(_t(t), _t(gidx), _t(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_grouped_ops_clamp_out_of_range_padding_index(rng, B):
    """A padding group's slot index past the table (or below it) clamps;
    its all-zero rows give zeros, as in the reference."""
    G, kappa, q, S = 3, 1, 16, 2
    x = np.zeros((G, B, kappa * q), np.float32)
    x[0] = _f32(rng, B, kappa * q)
    cores = _f32(rng, S, q, q, scale=q ** -0.5)
    c = _f32(rng, S, q, 5)
    gidx = np.array([1, S + 3, -4], np.int32)
    want_m = np.asarray(jops.morph_rows_grouped(
        jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(cores), kappa,
        backend="jnp",
    ))
    got_m = morph_rows_grouped(_t(x), _t(gidx), _t(cores), kappa)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=0, atol=ATOL)
    assert np.all(got_m.numpy()[1:] == 0.0)
    want_a = np.asarray(jops.aug_conv_forward_grouped(
        jnp.asarray(want_m), jnp.asarray(gidx), jnp.asarray(c), backend="jnp",
    ))
    got_a = aug_conv_forward_grouped(got_m, _t(gidx), _t(c))
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=0, atol=ATOL)
    # gidx may arrive as numpy int64 too: the entry point makes it int32
    again = aug_conv_forward_grouped(got_m, gidx.astype(np.int64), _t(c))
    np.testing.assert_array_equal(again.numpy(), got_a.numpy())


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
def test_wrappers_match_reference_refs(rng, name):
    """The wrappers (CPU path) against the reference's scan oracles, and the
    single-tenant plain versions against theirs."""
    gidx = np.array(GIDX_CASES[name], np.int32)
    x = _f32(rng, 4, 3, 2 * 12)
    cores = _f32(rng, 6, 12, 12)
    np.testing.assert_allclose(
        grouped_block_diag_matmul(_t(x), _t(gidx), _t(cores), 2).numpy(),
        np.asarray(jref.block_diag_matmul_grouped_ref(
            jnp.asarray(x), jnp.asarray(gidx), jnp.asarray(cores), 2)),
        rtol=0, atol=ATOL,
    )
    t = _f32(rng, 4, 3, 20)
    c = _f32(rng, 6, 20, 7)
    np.testing.assert_allclose(
        grouped_aug_gemm(_t(t), _t(gidx), _t(c)).numpy(),
        np.asarray(jref.aug_gemm_grouped_ref(
            jnp.asarray(t), jnp.asarray(gidx), jnp.asarray(c))),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        ref.block_diag_matmul_ref(_t(x[0]), _t(cores[1]), 2).numpy(),
        np.asarray(jref.block_diag_matmul_ref(
            jnp.asarray(x[0]), jnp.asarray(cores[1]), 2)),
        rtol=0, atol=ATOL,
    )
    np.testing.assert_allclose(
        ref.aug_gemm_ref(_t(t[0]), _t(c[1])).numpy(),
        np.asarray(jref.aug_gemm_ref(jnp.asarray(t[0]), jnp.asarray(c[1]))),
        rtol=0, atol=ATOL,
    )


def test_cpu_path_counts_no_launches(rng):
    """The launch counters move only where a CUDA kernel launches."""
    n1, n2 = grouped_block_diag_matmul.launches, grouped_aug_gemm.launches
    g = torch.tensor([0, 1], dtype=torch.int32)
    grouped_block_diag_matmul(_t(_f32(rng, 2, 2, 8)), g, _t(_f32(rng, 2, 8, 8)), 1)
    grouped_aug_gemm(_t(_f32(rng, 2, 2, 8)), g, _t(_f32(rng, 2, 8, 3)))
    assert (grouped_block_diag_matmul.launches, grouped_aug_gemm.launches) == (
        n1, n2
    )


def test_wrappers_reject_what_the_kernel_cannot_take(rng):
    t = _t(_f32(rng, 2, 3, 8))
    c = _t(_f32(rng, 4, 8, 5))
    g = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(TypeError):
        grouped_aug_gemm(t.double(), g, c)
    with pytest.raises(TypeError):
        grouped_aug_gemm(t, g.long(), c)
    with pytest.raises(ValueError):
        grouped_aug_gemm(t.transpose(1, 2).contiguous().transpose(1, 2), g, c)
    with pytest.raises(ValueError):
        grouped_aug_gemm(t, g, _t(_f32(rng, 4, 9, 5)))
    with pytest.raises(ValueError):
        grouped_aug_gemm(t, torch.tensor([0], dtype=torch.int32), c)
    with pytest.raises(ValueError):
        grouped_block_diag_matmul(t, g, _t(_f32(rng, 4, 3, 3)), 3)
    # A device with no kernel and no plain route raises instead of
    # computing somewhere else.
    with pytest.raises(ValueError, match="no kernel"):
        grouped_aug_gemm(t.to("meta"), g.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        grouped_block_diag_matmul(
            t.to("meta"), g.to("meta"), _t(_f32(rng, 4, 4, 4)).to("meta"), 2
        )


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    from repro_torch.kernels import build

    if build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    lib = build._library_path("aug_gemm")
    assert lib.parent == tmp_path / "kernels" and lib.suffix == ".so"
