"""The port's single-tenant and per-group morph (K4, ``block_diag_matmul``)
and Aug-Conv (K5, ``aug_gemm``) entry points on the CPU, against the JAX
reference's own functions on the same numpy inputs:

  * the Pallas kernels in interpret mode at ``tests/test_kernels.py``'s
    tileable sweeps (fp32 within 1e-4; bf16 within two bf16 units in the
    last place of max|reference|, where the reference allows 2e-1: both
    sides accumulate in fp32 and round once);
  * ``repro.kernels.ref`` at ragged shapes (atol 1e-5);
  * ``morph_rows_batched``/``aug_conv_forward_batched`` as
    ``tests/test_engine.py`` holds them (per-group protocol morphing; jnp
    and interpret backends).

On the CPU a wrapper runs its kernel's plain version (``kernels/ref.py``);
the CUDA kernels are held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import make_core as jmake_core, morph as jmorph  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import make_core, morph  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    aug_conv_forward, aug_conv_forward_batched, aug_gemm, block_diag_matmul,
    morph_rows, morph_rows_batched, ref,
)

ATOL = 1e-5
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype):
    """The same values as a torch and a jnp array of ``dtype`` (bf16 is
    rounded once, by torch, and handed to jnp as its exact fp32 value)."""
    t = torch.from_numpy(a).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy(), DTYPES[dtype][1])


def _hold(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        bound = 1e-4
    else:
        bound = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,kappa,q", [
    (128, 1, 128), (128, 3, 128), (8, 4, 128), (256, 2, 256), (64, 6, 128),
])
def test_morph_rows_matches_pallas_interpret(rng, R, kappa, q, dtype):
    x, jx = _both(_f32(rng, R, kappa * q), dtype)
    core, jc = _both(_f32(rng, q, q, scale=q ** -0.5), dtype)
    want = jops.morph_rows(jx, jc, kappa, backend="interpret")
    got = morph_rows(x, core, kappa)
    assert got.dtype == x.dtype
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,K,N", [(128, 512, 128), (8, 1024, 256), (64, 512, 384)])
def test_aug_conv_forward_matches_pallas_interpret(rng, B, K, N, dtype):
    t, jt = _both(_f32(rng, B, K), dtype)
    c, jc = _both(_f32(rng, K, N, scale=K ** -0.5), dtype)
    want = jops.aug_conv_forward(jt, jc, backend="interpret")
    got = aug_conv_forward(t, c)
    assert got.dtype == t.dtype
    _hold(got, want, dtype)


@pytest.mark.parametrize("R,kappa,q", [(10, 3, 10), (37, 3, 100), (5, 1, 7)])
def test_morph_rows_ragged_matches_reference(rng, R, kappa, q):
    x = _f32(rng, R, kappa * q)
    core = _f32(rng, q, q, scale=q ** -0.5)
    want = jref.block_diag_matmul_ref(jnp.asarray(x), jnp.asarray(core), kappa)
    got = morph_rows(torch.from_numpy(x), torch.from_numpy(core), kappa)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,K,N", [(7, 33, 9), (1, 600, 3), (130, 17, 129)])
def test_aug_conv_forward_ragged_matches_reference(rng, B, K, N):
    t = _f32(rng, B, K)
    c = _f32(rng, K, N, scale=K ** -0.5)
    want = jref.aug_gemm_ref(jnp.asarray(t), jnp.asarray(c))
    got = aug_conv_forward(torch.from_numpy(t), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_batched_matches_protocol_morph(rng):
    """morph_rows_batched == per-group protocol morphing, in both packages
    (tests/test_engine.py::test_batched_dispatch_matches_protocol_morph)."""
    kappa, q, G, B = 2, 16, 3, 5
    cores = [make_core(rng, kappa * q, kappa) for _ in range(G)]
    x = _f32(rng, G, B, kappa * q)
    stack = np.stack([c.matrix for c in cores])
    got = morph_rows_batched(torch.from_numpy(x), torch.from_numpy(stack), kappa)
    jgot = jops.morph_rows_batched(jnp.asarray(x), jnp.asarray(stack), kappa,
                                   backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=ATOL)
    for g in range(G):
        want = morph(torch.from_numpy(x[g]), cores[g])
        np.testing.assert_allclose(got[g].numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_match_pallas_interpret(rng, dtype):
    """Tileable batched shapes against the reference's vmapped Pallas
    kernels (tests/test_engine.py::test_batched_dispatch_backends_agree)."""
    G, B, kappa, q = 2, 8, 2, 128
    x, jx = _both(_f32(rng, G, B, kappa * q), dtype)
    cores, jcores = _both(_f32(rng, G, q, q, scale=q ** -0.5), dtype)
    _hold(morph_rows_batched(x, cores, kappa),
          jops.morph_rows_batched(jx, jcores, kappa, backend="interpret"), dtype)
    t, jt = _both(_f32(rng, G, 8, 256), dtype)
    c, jc = _both(_f32(rng, G, 256, 128, scale=1 / 16), dtype)
    _hold(aug_conv_forward_batched(t, c),
          jops.aug_conv_forward_batched(jt, jc, backend="interpret"), dtype)


def test_batched_ragged_matches_reference(rng):
    """Non-tileable batched shapes (the reference routes them to its jnp
    oracles on every backend)."""
    G, B, kappa, q = 2, 3, 3, 10
    x = _f32(rng, G, B, kappa * q)
    cores = _f32(rng, G, q, q, scale=q ** -0.5)
    want = jref.block_diag_matmul_batched_ref(jnp.asarray(x), jnp.asarray(cores), kappa)
    got = morph_rows_batched(torch.from_numpy(x), torch.from_numpy(cores), kappa)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    t, c = _f32(rng, G, 5, 33), _f32(rng, G, 33, 9, scale=33 ** -0.5)
    want = jref.aug_gemm_batched_ref(jnp.asarray(t), jnp.asarray(c))
    got = aug_conv_forward_batched(torch.from_numpy(t), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        ref.aug_gemm_batched_ref(torch.from_numpy(t), torch.from_numpy(c)).numpy(),
        np.asarray(want), rtol=0, atol=ATOL)


def test_morph_rows_equals_protocol_math(rng):
    """The kernel's entry point == protocol-level morphing, and both equal
    the reference's (tests/test_kernels.py::test_kernel_equals_protocol_math)."""
    core = make_core(rng, 512, kappa=4)
    x = _f32(rng, 16, 512)
    got = morph_rows(torch.from_numpy(x), torch.from_numpy(core.matrix), 4)
    np.testing.assert_allclose(got.numpy(), morph(torch.from_numpy(x), core).numpy(),
                               rtol=0, atol=ATOL)
    jcore = jmake_core(np.random.default_rng(3), 512, kappa=4)
    want = jmorph(jnp.asarray(x), jcore)
    got = morph_rows(torch.from_numpy(x), torch.from_numpy(jcore.matrix), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_cpu_path_counts_no_launches(rng):
    n4, n5 = block_diag_matmul.launches, aug_gemm.launches
    morph_rows(torch.from_numpy(_f32(rng, 4, 6)), torch.from_numpy(_f32(rng, 3, 3)), 2)
    morph_rows_batched(torch.from_numpy(_f32(rng, 2, 4, 6)),
                       torch.from_numpy(_f32(rng, 2, 3, 3)), 2)
    aug_conv_forward(torch.from_numpy(_f32(rng, 4, 6)), torch.from_numpy(_f32(rng, 6, 5)))
    aug_conv_forward_batched(torch.from_numpy(_f32(rng, 2, 4, 6)),
                             torch.from_numpy(_f32(rng, 2, 6, 5)))
    assert (block_diag_matmul.launches, aug_gemm.launches) == (n4, n5)


def test_wrappers_reject_what_the_kernel_cannot_take(rng):
    x = torch.from_numpy(_f32(rng, 4, 6))
    core = torch.from_numpy(_f32(rng, 3, 3))
    t = torch.from_numpy(_f32(rng, 4, 6))
    c = torch.from_numpy(_f32(rng, 6, 5))
    # Mixed or unsupported dtypes.
    with pytest.raises(TypeError, match="one dtype"):
        block_diag_matmul(x, core.bfloat16(), 2)
    with pytest.raises(TypeError, match="one dtype"):
        aug_gemm(t.bfloat16(), c)
    with pytest.raises(TypeError, match="one dtype"):
        aug_gemm(t.double(), c.double())
    # Non-contiguous operands (the entry points make the activation
    # contiguous; the secret must already be).
    with pytest.raises(ValueError, match="contiguous"):
        block_diag_matmul(x, core.t(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        aug_gemm(t.t().contiguous().t(), c)
    with pytest.raises(ValueError, match="contiguous"):
        aug_conv_forward(t, c.t().contiguous().t())
    assert aug_conv_forward(t.t().contiguous().t(), c).shape == (4, 5)
    # Mismatched shapes.
    with pytest.raises(ValueError, match="kappa=3 blocks"):
        block_diag_matmul(x, core, 3)
    with pytest.raises(ValueError, match="kappa=2 blocks"):
        block_diag_matmul(x[None], core[None].expand(2, 3, 3).contiguous(), 2)
    with pytest.raises(ValueError, match="does not match"):
        aug_gemm(t, c[:5].contiguous())
    with pytest.raises(ValueError, match="does not match"):
        aug_gemm(t[None], c)
    with pytest.raises(ValueError, match="empty"):
        aug_gemm(t[:0], c)
    # Operands on two devices, and a device with no kernel and no plain route.
    with pytest.raises(ValueError, match="different devices"):
        aug_gemm(t, c.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        aug_gemm(t.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        block_diag_matmul(x.to("meta"), core.to("meta"), 2)
    # No backward: an operand that requires grad raises on every device.
    with pytest.raises(RuntimeError, match="no backward"):
        aug_gemm(t.requires_grad_(), c)
    with pytest.raises(RuntimeError, match="no backward"):
        block_diag_matmul(x, core.requires_grad_(), 2)
