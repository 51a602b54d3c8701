"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions on the same inputs (no JAX: this file runs where only the
port is installed).  Every test needs a GPU and skips without one.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ConvGeometry, SessionRegistry  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    aug_conv_forward_grouped, grouped_aug_gemm, grouped_block_diag_matmul,
    morph_rows_grouped, ref,
)
from repro_torch.runtime import DeliveryRequest, MoLeDeliveryEngine  # noqa: E402

pytestmark = pytest.mark.cuda

GIDX_CASES = {
    "identity": [0, 1, 2, 3],
    "partial_table": [0, 1, 2, 4],
    "out_of_order": [4, 0, 5, 2],
    "duplicates": [3, 3, 1, 3],
    "out_of_range": [1, 9, -2, 5],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)
    )


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("B,K,N", [(8, 256, 128), (3, 300, 100), (70, 129, 131)])
def test_grouped_aug_gemm_kernel_matches_plain(rng, cuda, name, B, K, N):
    t = _rand(rng, 4, B, K)
    c = _rand(rng, 6, K, N, scale=K ** -0.5)
    gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32)
    want = ref.aug_gemm_grouped_ref(t, gidx, c)
    before = grouped_aug_gemm.launches
    got = grouped_aug_gemm(t.to(cuda), gidx.to(cuda), c.to(cuda)).cpu()
    assert grouped_aug_gemm.launches == before + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("B,kappa,q", [(8, 2, 128), (3, 3, 100), (65, 1, 70)])
def test_grouped_block_diag_kernel_matches_plain(rng, cuda, name, B, kappa, q):
    x = _rand(rng, 4, B, kappa * q)
    cores = _rand(rng, 6, q, q, scale=q ** -0.5)
    gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32)
    want = ref.block_diag_matmul_grouped_ref(x, gidx, cores, kappa)
    before = grouped_block_diag_matmul.launches
    got = grouped_block_diag_matmul(
        x.to(cuda), gidx.to(cuda), cores.to(cuda), kappa
    ).cpu()
    assert grouped_block_diag_matmul.launches == before + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_ops_launch_kernels_for_any_shape(rng, cuda):
    """The entry points take ragged B/K/N straight to the kernels."""
    x = _rand(rng, 3, 5, 30)
    cores = _rand(rng, 4, 10, 10)
    c = _rand(rng, 4, 30, 7)
    gidx = np.array([2, 0, 7], np.int32)
    n1, n2 = grouped_block_diag_matmul.launches, grouped_aug_gemm.launches
    morphed = morph_rows_grouped(x.to(cuda), gidx, cores.to(cuda), 3)
    out = aug_conv_forward_grouped(morphed, gidx, c.to(cuda)).cpu()
    assert (grouped_block_diag_matmul.launches, grouped_aug_gemm.launches) == (
        n1 + 1, n2 + 1
    )
    want = aug_conv_forward_grouped(
        morph_rows_grouped(x, gidx, cores, 3), gidx, c
    )
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_engine_on_card_matches_cpu_under_eviction(rng, cuda):
    """Capacity below the tenant count: slots are evicted inside one flush
    round, and the card's copy-on-write keeps each microbatch on the secrets
    its gidx was built against."""
    geom = ConvGeometry(3, 16, 8, 3)
    reg = SessionRegistry(geom, kappa=2, capacity=2)
    for i in range(5):
        k = rng.standard_normal((3, 16, 3, 3)).astype(np.float32)
        reg.register(f"t{i}", k, seed=i)
    reqs = [
        DeliveryRequest(f"t{i % 5}", rng.standard_normal(
            (1 + i % 3, 3, 8, 8)).astype(np.float32))
        for i in range(15)
    ]
    eng = MoLeDeliveryEngine(reg, cuda)
    rids = [eng.submit(q) for q in reqs]
    eng.flush()
    for rid, q in zip(rids, reqs):
        want = reg.session(q.tenant_id).deliver(torch.from_numpy(q.payload))
        np.testing.assert_allclose(eng.take(rid), want.numpy(), atol=1e-4)
