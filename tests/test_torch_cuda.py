"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions on the same inputs (no JAX: this file runs where only the
port is installed).  Every test needs a GPU and skips without one.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    ConvGeometry, DataProvider, SessionRegistry, conv_reference,
)
from repro_torch.kernels import (  # noqa: E402
    aug_conv_forward, aug_conv_forward_batched, aug_conv_forward_grouped,
    aug_gemm, block_diag_matmul, grouped_aug_gemm, grouped_block_diag_matmul,
    grouped_row_gemm, lm_head_rows_grouped, morph_rows, morph_rows_batched,
    morph_rows_grouped, ref, wkv6_chunked, wkv6_rows, wkv6_scan,
)
from repro_torch.kernels import gemm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model, cnn, stack  # noqa: E402
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
@pytest.mark.parametrize("B,kappa,q", [(8, 2, 128), (3, 3, 100), (65, 1, 70),
                                       (64, 1, 3072)])
def test_grouped_block_diag_kernel_matches_plain(rng, cuda, name, B, kappa, q):
    """K1 (the morph kernel, split by the wrapper's rule) against its plain
    version, incl. the main path's (4, 64, 3072) over 6 slots of 3072^2."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("K,N", [(512, 2048), (300, 1000), (129, 131)])
def test_grouped_row_gemm_kernel_matches_plain(rng, cuda, name, dtype, K, N):
    """K3 against its plain version: fp32 within 1e-4 * max|plain|; bf16
    within two bf16 units in the last place of max|plain| (each side rounds
    once; the sums run in other orders).  N = 131 runs the scalar variant."""
    h = _rand(rng, 4, K).to(dtype)
    tables = _rand(rng, 6, K, N, scale=K ** -0.5)
    gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32)
    safe = gidx.clamp(0, 5)
    want = ref.lm_head_rows_grouped_ref(
        h.to(cuda), safe.to(cuda), tables.to(cuda)
    ).float().cpu()
    before = grouped_row_gemm.launches
    got = lm_head_rows_grouped(h.to(cuda), gidx.numpy(), tables.to(cuda))
    torch.cuda.synchronize()
    assert grouped_row_gemm.launches == before + 1
    assert got.dtype == dtype and got.shape == (4, N)
    scale = float(want.abs().max())
    bound = (1e-4 * scale if dtype == torch.float32
             else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7))
    assert float((got.float().cpu() - want).abs().max()) <= bound


def _hold(got, want, dtype):
    """fp32 within 1e-4 * max|plain|; bf16 within two bf16 units in the last
    place of max|plain| (each side accumulates in fp32 and rounds once)."""
    scale = float(want.float().abs().max())
    bound = (1e-4 * scale if dtype == torch.float32
             else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float().cpu() - want.float().cpu()).abs().max()) <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,R,kappa,q", [
    (None, 64, 1, 768), (None, 37, 3, 100), (None, 256, 3, 128),
    (3, 20, 2, 130), (2, 64, 1, 256), (None, 256, 1, 3072), (4, 64, 1, 3072),
])
def test_block_diag_kernel_matches_plain(rng, cuda, dtype, G, R, kappa, q):
    """K4, single-tenant (G None) and one core per group, incl. the main
    shapes (q = 3072 at 256 rows and at (4, 64), split by the wrapper's
    rule)."""
    lead = () if G is None else (G,)
    x = _rand(rng, *lead, R, kappa * q).to(dtype)
    core = _rand(rng, *lead, q, q, scale=q ** -0.5).to(dtype)
    plain = (ref.block_diag_matmul_ref if G is None
             else ref.block_diag_matmul_batched_ref)
    want = plain(x.to(cuda), core.to(cuda), kappa)
    before = block_diag_matmul.launches
    got = block_diag_matmul(x.to(cuda), core.to(cuda), kappa)
    torch.cuda.synchronize()
    assert block_diag_matmul.launches == before + 1
    _hold(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,B,K,N", [
    (None, 7, 33, 9), (None, 64, 768, 4096), (None, 130, 257, 129),
    (2, 8, 256, 128), (3, 5, 300, 1000),
])
def test_aug_gemm_kernel_matches_plain(rng, cuda, dtype, G, B, K, N):
    """K5, single-tenant (G None) and one matrix per group."""
    lead = () if G is None else (G,)
    t = _rand(rng, *lead, B, K).to(dtype)
    c = _rand(rng, *lead, K, N, scale=K ** -0.5).to(dtype)
    plain = ref.aug_gemm_ref if G is None else ref.aug_gemm_batched_ref
    want = plain(t.to(cuda), c.to(cuda))
    before = aug_gemm.launches
    got = aug_gemm(t.to(cuda), c.to(cuda))
    torch.cuda.synchronize()
    assert aug_gemm.launches == before + 1
    _hold(got, want, dtype)


def _aug_operands(rng, form, cuda):
    """K2/K5 at a medium shape, (64 or 256, 3072) @ (3072, 4096), and the
    kernel call on them: (t, c, gidx or None, call)."""
    K, N = 3072, 4096
    if form == "K2":
        t = _rand(rng, 4, 64, K).to(cuda)
        c = _rand(rng, 6, K, N, scale=K ** -0.5).to(cuda)
        gidx = torch.tensor([4, 0, 5, 2], dtype=torch.int32, device=cuda)
        return t, c, gidx, lambda: grouped_aug_gemm(t, gidx, c)
    B = int(form.split("/")[1])
    t = _rand(rng, B, K).to(cuda)
    c = _rand(rng, K, N, scale=K ** -0.5).to(cuda)
    return t, c, None, lambda: aug_gemm(t, c)


@pytest.mark.parametrize("form", ["K2", "K5/64", "K5/256"])
def test_aug_kernels_hold_fp64_bound(rng, cuda, form):
    """K2 and K5 in fp32 (split TF32 on the tensor cores, both tile shapes)
    against a float64 product on the card: within 1e-5 * max|fp64|, the
    delivery reference's own bound."""
    t, c, gidx, call = _aug_operands(rng, form, cuda)
    got = call()
    if gidx is None:
        want = t.double() @ c.double()
    else:
        want = torch.bmm(t.double(), c[gidx.long()].double())
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("form", ["K2", "K5/64", "K5/256", "K5/256/bfloat16"])
def test_aug_kernels_are_deterministic(rng, cuda, form):
    """K2 and K5 (no atomics, a fixed order) give the same bits on two
    calls with the same inputs, fp32 and bf16."""
    t, c, _, call = _aug_operands(rng, form.replace("/bfloat16", ""), cuda)
    if form.endswith("bfloat16"):
        tb, cb = t.bfloat16(), c.bfloat16()
        call = lambda: aug_gemm(tb, cb)  # noqa: E731
    first, second = call(), call()
    torch.cuda.synchronize()
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


@pytest.mark.parametrize("G,M,K,floats", [
    (1, 256, 3072, 96 * 2 * 256 * 32),     # K5: 96 stages of 32 k, 128-row tiles
    (4, 64, 3072, 4 * 96 * 2 * 64 * 32),   # K2: one 64-row tile per group
    (1, 130, 257, 9 * 2 * 256 * 32),       # ragged: rows and k rounded up
    (3, 5, 300, 3 * 10 * 2 * 64 * 32),
])
def test_workspace_is_the_split_layout(cuda, G, M, K, floats):
    """The library's workspace count holds, per group, stage of 32 k and
    hi / lo, the rows rounded up to the kernel's row tile (64 where M <= 64,
    else 128) times 32 floats: the layout ``split_t_kernel`` writes and the
    GEMM's bulk copies read."""
    assert gemm.aug_workspace_floats(G, M, K) == floats


# The morph kernel's edges, through its binding with the split given:
# (G, M, q, splits).  BK = 16; "unaligned" rows are not a whole number of
# 16-byte copies (fp32: q % 4, bf16: q % 8), so they load by masked scalars.
MORPH_EDGES = [
    (1, 40, 1000, 3),   # K = 1000 not a multiple of splits * BK = 48
    (2, 5, 10, 1),      # K < BK
    (1, 64, 256, 1),    # one slice: the kernel rounds to T itself
    (3, 70, 70, 2),     # unaligned q = 70, two slices
    (1, 33, 100, 2),    # q = 100: fp32 rows aligned, bf16 rows not
    (2, 9, 130, 3),     # unaligned q = 130, the last slice short
    (1, 130, 384, 5),   # three row tiles, five slices
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,q,splits", MORPH_EDGES)
def test_morph_kernel_edges_per_group(rng, cuda, dtype, G, M, q, splits):
    """K4's entry point (slot = group) at the kernel's edges against the
    plain per-group morph: fp32 within 1e-4 * max, bf16 two ulps."""
    a = _rand(rng, G, M, q).to(dtype).to(cuda)
    b = _rand(rng, G, q, q, scale=q ** -0.5).to(dtype).to(cuda)
    got = gemm.morph("block_diag_matmul", a, None, b, splits)
    want = ref.block_diag_matmul_batched_ref(a, b, 1)
    torch.cuda.synchronize()
    _hold(got, want, dtype)


@pytest.mark.parametrize("name", sorted(GIDX_CASES))
@pytest.mark.parametrize("G,M,q,splits", MORPH_EDGES)
def test_morph_kernel_edges_slot_indexed(rng, cuda, name, G, M, q, splits):
    """K1's entry point (fp32, gidx clamped into 6 slots) at the kernel's
    edges against the plain grouped morph, within 1e-4 * max."""
    a = _rand(rng, 4, M, q).to(cuda)
    b = _rand(rng, 6, q, q, scale=q ** -0.5).to(cuda)
    gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32, device=cuda)
    got = gemm.morph("grouped_block_diag_matmul", a, gidx, b, splits)
    want = ref.block_diag_matmul_grouped_ref(a, gidx, b, 1)
    torch.cuda.synchronize()
    _hold(got, want, torch.float32)


@pytest.mark.parametrize("case", ["K1", "K4/float32", "K4/bfloat16"])
def test_morph_kernels_are_deterministic(rng, cuda, case):
    """K1 and K4 at the main shapes, their sums split into slices (no
    atomics: the slices are added in a fixed order), give the same bits on
    two calls with the same inputs; so does an explicit split of 4."""
    if case == "K1":
        x = _rand(rng, 4, 64, 3072).to(cuda)
        cores = _rand(rng, 6, 3072, 3072, scale=3072 ** -0.5).to(cuda)
        gidx = torch.tensor([4, 0, 5, 2], dtype=torch.int32, device=cuda)
        calls = [lambda: grouped_block_diag_matmul(x, gidx, cores, 1),
                 lambda: gemm.morph(case, x, gidx, cores, 4)]
    else:
        dtype = getattr(torch, case.split("/")[1])
        x = _rand(rng, 256, 3072).to(dtype).to(cuda)
        core = _rand(rng, 3072, 3072, scale=3072 ** -0.5).to(dtype).to(cuda)
        calls = [lambda: block_diag_matmul(x, core, 1),
                 lambda: gemm.morph(case, x[None], None, core[None], 4)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        bits = torch.int32 if first.dtype == torch.float32 else torch.int16
        assert torch.equal(first.view(bits), second.view(bits))


def test_k4_k5_entry_points_and_refusals_on_card(rng, cuda):
    """The four public entry points launch one kernel each; an operand that
    requires grad and mixed dtypes raise on the card as on the CPU."""
    x, core = _rand(rng, 6, 20).to(cuda), _rand(rng, 10, 10).to(cuda)
    t, c = _rand(rng, 6, 20).to(cuda), _rand(rng, 20, 9).to(cuda)
    n4, n5 = block_diag_matmul.launches, aug_gemm.launches
    morph_rows(x, core, 2)
    morph_rows_batched(x[None], core[None], 2)
    aug_conv_forward(t, c)
    aug_conv_forward_batched(t[None], c[None])
    assert (block_diag_matmul.launches, aug_gemm.launches) == (n4 + 2, n5 + 2)
    with pytest.raises(RuntimeError, match="no backward"):
        aug_gemm(t, c.clone().requires_grad_())
    with pytest.raises(TypeError, match="one dtype"):
        block_diag_matmul(x, core.bfloat16(), 2)


def test_vgg_small_aug_path_on_card_equals_plain(rng, cuda):
    """Aug-VGG through K4 and K5 on the card, with the channel permutation
    absorbed, against plain VGG on the raw images (cuDNN, TF32 off): within
    1e-3 * max|plain logits|; K5's first-layer features against the
    convolution within 1e-4 * max|conv|."""
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    cfg = cnn.vgg_small()
    params = cnn.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    geom = cfg.first_geom
    prov = DataProvider(geom, kappa=1, seed=0)
    kern = cnn.first_layer_kernels(params, cfg)
    aug = prov.build_aug_conv(kern.cpu().numpy())
    perm = torch.from_numpy(aug.channel_perm).to(dev)
    p2 = {"convs": [dict(cv) for cv in params["convs"]], "head": params["head"]}
    p2["convs"][0]["b"] = params["convs"][0]["b"][perm]
    p2["convs"][1] = {"w": params["convs"][1]["w"][:, perm],
                      "b": params["convs"][1]["b"]}
    x = _rand(rng, 8, 3, cfg.image_size, cfg.image_size).to(dev)
    core = torch.from_numpy(prov._core.matrix).to(dev)
    mat = torch.from_numpy(aug.matrix).to(dev)
    n4, n5 = block_diag_matmul.launches, aug_gemm.launches
    rows = morph_rows(x.reshape(8, -1), core, 1)
    via_aug = cnn.apply(p2, rows, cfg, aug_matrix=mat)
    feats = aug_conv_forward(rows, mat).reshape(8, geom.beta, geom.n, geom.n)
    torch.cuda.synchronize()
    assert (block_diag_matmul.launches, aug_gemm.launches) == (n4 + 1, n5 + 2)
    plain = cnn.apply(params, x, cfg)
    assert float((via_aug - plain).abs().max()) <= 1e-3 * float(plain.abs().max())
    conv = conv_reference(x, kern, geom)[:, perm]
    assert float((feats - conv).abs().max()) <= 1e-4 * float(conv.abs().max())


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


@pytest.mark.parametrize("kappa", [1, 2])
def test_k1_k2_at_the_features_shapes(cuda, kappa):
    """K1 and K2 at the features lane's full width (Llama-3.2-Vision-90B's
    frontend, d_in 7680 -> d_model 8192, one (4, 64) microbatch; kappa 2
    gives q = 3840), slots out of order: each against its plain version
    within 1e-4 * max|plain|, and the two in a row (morph, then the
    projection) against a float64 product on the card over the first 1024
    columns within 1e-5 * max|fp64|."""
    G, B, d_in, d_out, cols = 4, 64, 7680, 8192, 1024
    q = d_in // kappa
    gen = torch.Generator(device=cuda).manual_seed(kappa)
    x = torch.randn((G, B, d_in), generator=gen, device=cuda)
    cores = torch.randn((G, q, q), generator=gen, device=cuda) * q ** -0.5
    projs = torch.randn((G, d_in, d_out), generator=gen, device=cuda) * d_in ** -0.5
    gidx = torch.tensor([3, 1, 0, 2], dtype=torch.int32, device=cuda)
    k1, k2 = grouped_block_diag_matmul.launches, grouped_aug_gemm.launches
    t = grouped_block_diag_matmul(x, gidx, cores, kappa)
    y = grouped_aug_gemm(t, gidx, projs)
    torch.cuda.synchronize()
    assert (grouped_block_diag_matmul.launches, grouped_aug_gemm.launches) == (
        k1 + 1, k2 + 1)
    for got, want in ((t, ref.block_diag_matmul_grouped_ref(x, gidx, cores, kappa)),
                      (y, ref.aug_gemm_grouped_ref(t, gidx, projs))):
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err
    slots = gidx.long()
    t64 = torch.bmm(x.double().view(G, B * kappa, q), cores[slots].double())
    want = torch.bmm(t64.view(G, B, d_in), projs[slots, :, :cols].double())
    err = float((y[..., :cols].double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_features_engine_on_card_matches_cpu(rng, cuda):
    """The engine's features lane on the card (K1 then K2 per microbatch,
    capacity below the tenant count) against per-request delivery on the
    CPU, within 1e-4 * max."""
    from repro_torch.core import LMSessionRegistry

    d_in, d_out = 96, 80
    reg = LMSessionRegistry(64, 16, d_in=d_in, d_out=d_out, kappa=2,
                            capacity=2)
    for i in range(4):
        reg.register(f"t{i}", rng.standard_normal((64, 16)).astype(np.float32),
                     w_in=rng.standard_normal((d_in, d_out)).astype(
                         np.float32) / np.sqrt(d_in), seed=i)
    reqs = [DeliveryRequest(f"t{i % 4}", rng.standard_normal(
        ((1, 7, d_in), (5, d_in))[i % 2]).astype(np.float32), lane="features")
        for i in range(10)]
    eng = MoLeDeliveryEngine(lm_registry=reg, device=cuda)
    k1, k2 = grouped_block_diag_matmul.launches, grouped_aug_gemm.launches
    rids = [eng.submit(q) for q in reqs]
    eng.flush()
    n_mb = eng.stats.microbatches
    assert (grouped_block_diag_matmul.launches - k1,
            grouped_aug_gemm.launches - k2) == (n_mb, n_mb)
    for rid, q in zip(rids, reqs):
        want = reg.session(q.tenant_id).deliver_features(
            torch.from_numpy(q.payload)).numpy()
        got = eng.take(rid)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


def _scan_ops(rng, BH, T, D):
    r, k, v = (_rand(rng, BH, T, D) for _ in range(3))
    logw = -torch.exp(_rand(rng, BH, T, D))
    return r, k, v, logw, _rand(rng, BH, D), _rand(rng, BH, D, D, scale=0.1)


@pytest.mark.parametrize("BH,T,D,chunk", [
    (4, 64, 16, 16), (4, 128, 16, 32), (4, 96, 64, 32), (40, 384, 64, 128),
    (160, 128, 64, 128), (3, 100, 64, 128), (1, 256, 64, 128), (2, 12, 16, 4),
])
def test_wkv6_kernel_matches_plain(rng, cuda, BH, T, D, chunk):
    """K6 (fp32) against the plain chunked scan and the token recurrence,
    out and final state within 1e-4 * max|plain|, over the reference's
    sweep, the prefill's width (40 heads of 64, chunk 128), T < chunk, one
    block per SM and many."""
    ops = _scan_ops(rng, BH, T, D)
    want_o, want_s = ref.wkv6_chunked_ref(*ops, chunk=chunk)
    rec_o, rec_s = ref.wkv6_ref(*(a[None] for a in ops[:4]), ops[4],
                                ops[5][None])
    before = wkv6_chunked.launches
    got_o, got_s = wkv6_chunked(*(a.to(cuda) for a in ops), chunk=chunk)
    torch.cuda.synchronize()
    assert wkv6_chunked.launches == before + 1
    for got, want in ((got_o, want_o), (got_s, want_s),
                      (got_o, rec_o[0]), (got_s, rec_s[0])):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


def test_wkv6_kernel_bf16_and_refusals(rng, cuda):
    """bf16 operands run the fp32 kernel and round ``out`` once (within two
    bf16 ulps of the plain version's max, which rounds the same way); head
    sizes and chunks without a kernel raise."""
    ops = [a.to(cuda) for a in _scan_ops(rng, 8, 64, 64)]
    bf = [a.bfloat16() for a in ops[:5]] + [ops[5]]
    got_o, got_s = wkv6_chunked(*bf, chunk=32)
    want_o, want_s = ref.wkv6_chunked_ref(*bf, chunk=32)
    torch.cuda.synchronize()
    assert got_o.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    scale = float(want_o.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((got_o.float() - want_o.float()).abs().max()) <= 2 * ulp
    assert float((got_s - want_s).abs().max()) <= 1e-4 * float(want_s.abs().max())
    with pytest.raises(ValueError, match="no kernel"):
        wkv6_chunked(*[a.to(cuda) for a in _scan_ops(rng, 2, 8, 32)], chunk=8)
    with pytest.raises(ValueError, match="no kernel"):
        wkv6_chunked(*[a.to(cuda) for a in _scan_ops(rng, 2, 256, 16)],
                     chunk=256)


def _scan_vs_recurrence(ops, got_o, got_s):
    """K6's out and final state against the token recurrence on the same
    (card) operands, within 1e-4 * max|recurrence|."""
    want_o, want_s = ref.wkv6_ref(*(a[None] for a in ops[:4]), ops[4],
                                  ops[5][None])
    for got, want in ((got_o, want_o[0]), (got_s, want_s[0])):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


def test_wkv6_kernel_gives_same_bits_twice(rng, cuda):
    """Two calls at the prefill's shape (40 heads of 64, T = 384) give the
    same bits: no atomics, one order of summation."""
    ops = [a.to(cuda) for a in _scan_ops(rng, 40, 384, 64)]
    o1, s1 = wkv6_chunked(*ops, chunk=128)
    o2, s2 = wkv6_chunked(*ops, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(o1.view(torch.int32), o2.view(torch.int32))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


@pytest.mark.parametrize("decay", ["strong", "none"])
@pytest.mark.parametrize("BH,T,D,chunk", [(40, 384, 64, 128), (8, 100, 64, 20),
                                          (4, 256, 16, 64)])
def test_wkv6_kernel_strong_and_no_decay(rng, cuda, decay, BH, T, D, chunk):
    """logw = -exp(2 N) (most decays underflow to 0) and logw = 0 (the
    state only grows) against the token recurrence."""
    r, k, v, logw, u, s0 = (a.to(cuda) for a in _scan_ops(rng, BH, T, D))
    z = _rand(rng, BH, T, D).to(cuda)
    logw = -torch.exp(2 * z) if decay == "strong" else torch.zeros_like(z)
    ops = (r, k, v, logw, u, s0)
    got_o, got_s = wkv6_chunked(*ops, chunk=chunk)
    _scan_vs_recurrence(ops, got_o, got_s)


@pytest.mark.parametrize("BH,D", [(1, 64), (40, 64), (3, 16)])
def test_wkv6_kernel_one_token(rng, cuda, BH, D):
    """T = 1: one tile with 31 padded rows."""
    ops = [a.to(cuda) for a in _scan_ops(rng, BH, 1, D)]
    got_o, got_s = wkv6_chunked(*ops, chunk=128)
    _scan_vs_recurrence(ops, got_o, got_s)


def test_wkv6_kernel_long_sequence(rng, cuda):
    """(40, 4096, 64): 128 tiles through the ring, against the token
    recurrence."""
    ops = [a.to(cuda) for a in _scan_ops(rng, 40, 4096, 64)]
    got_o, got_s = wkv6_chunked(*ops, chunk=128)
    _scan_vs_recurrence(ops, got_o, got_s)


@pytest.mark.parametrize("BH,T,D", [(40, 100, 64), (6, 70, 16)])
def test_wkv6_kernel_every_geometry(rng, cuda, BH, T, D):
    """Every block width C the kernel takes at D, through the binding,
    against the token recurrence; a width it does not take (5 columns: no
    whole warp at either head size) is refused at launch."""
    ops = [a.to(cuda) for a in _scan_ops(rng, BH, T, D)]
    for C in gemm.scan_widths(D):
        got_o, got_s = gemm.scan("wkv6_chunked", *ops, width=C)
        _scan_vs_recurrence(ops, got_o, got_s)
    with pytest.raises(RuntimeError, match="launch failed"):
        gemm.scan("wkv6_chunked", *ops, width=5)


def test_rwkv_smoke_model_on_card_equals_cpu(rng, cuda):
    """The rwkv6_3b smoke model (fp32) on the card, its time-mix prefill
    through K6 (one launch per layer), against the same weights on the CPU:
    forward logits within 1e-4 * max, then a prefill and two decode steps,
    both sides fed the CPU's greedy tokens, logits within 1e-4 * max at
    every step."""
    cfg = get_smoke_config("rwkv6_3b")
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    card = Model(cfg, "cuda")
    params_c = copy.deepcopy(params).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 11)))

    def close(got, want):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err

    want, _ = stack.forward(params, cfg, tokens)
    before = wkv6_chunked.launches
    got, _ = stack.forward(params_c, cfg, tokens.to(cuda))
    torch.cuda.synchronize()
    assert wkv6_chunked.launches == before + cfg.n_layers
    close(got, want)
    lc, cc = cpu.prefill(params, {"tokens": tokens}, 16)
    lg, cg = card.prefill(params_c, {"tokens": tokens.to(cuda)}, 16)
    close(lg, lc)
    for t in range(11, 13):
        tok = torch.argmax(lc[:, 0], -1)[:, None]
        lc, cc = cpu.decode(params, tok, t, cc)
        lg, cg = card.decode(params_c, tok.to(cuda), t, cg)
        close(lg, lc)


def _rows_ops(rng, BH, T, D, decay="ordinary"):
    x, y, z, w = (_rand(rng, BH, T, D) for _ in range(4))
    logw = {"ordinary": -torch.exp(w), "strong": -torch.exp(2 * w),
            "weak": -torch.exp(w - 3)}[decay]
    return x, y, z, logw, _rand(rng, BH, D, D, scale=0.1)


@pytest.mark.parametrize("decay", ["ordinary", "strong", "weak"])
@pytest.mark.parametrize("BH,T,D", [(3, 45, 16), (2, 100, 64), (4, 33, 64),
                                    (80, 1, 64), (5, 1, 16), (80, 1000, 64)])
def test_wkv6_rows_kernel_matches_plain(rng, cuda, BH, T, D, decay):
    """The key-row scan (``csrc/wkv6_rows.cu``) against its plain version on
    the same card operands, within 1e-4 * max|plain| (K6's bound: both
    take the decays by ex2.approx or exp, and sum in another order), at
    both head sizes, ragged T (the last tile partial), T = 1 and the
    training shape's width (80 sequences); one launch a call."""
    ops = [a.to(cuda) for a in _rows_ops(rng, BH, T, D, decay)]
    want = ref.wkv6_rows_ref(*ops)
    before = wkv6_rows.launches
    got = wkv6_rows(*ops)
    torch.cuda.synchronize()
    assert wkv6_rows.launches == before + 1
    assert got.shape == (BH, T, D) and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("BH,T,D", [(80, 512, 64), (7, 70, 16)])
def test_wkv6_rows_kernel_gives_same_bits_twice(rng, cuda, BH, T, D):
    ops = [a.to(cuda) for a in _rows_ops(rng, BH, T, D)]
    a, b = wkv6_rows(*ops), wkv6_rows(*ops)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _rows_ops_on(cuda, seed, BH, T, D, decay="ordinary"):
    """``_rows_ops``'s distributions drawn on the card, for shapes whose
    draw on the host would take long."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x, y, z, w = (torch.randn((BH, T, D), generator=gen, device=cuda)
                  for _ in range(4))
    logw = {"ordinary": -torch.exp(w), "strong": -torch.exp(2 * w)}[decay]
    return x, y, z, logw, 0.1 * torch.randn((BH, D, D), generator=gen, device=cuda)


def _rows_held_twice(ops):
    """The key-row kernel within 1e-4 * max|plain| of its plain version,
    finite, one launch a call, the same bits twice."""
    want = ref.wkv6_rows_ref(*ops)
    before = wkv6_rows.launches
    got, again = wkv6_rows(*ops), wkv6_rows(*ops)
    torch.cuda.synchronize()
    assert wkv6_rows.launches == before + 2
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("dT", [-1, 0, 1])
@pytest.mark.parametrize("D", [16, 64])
def test_wkv6_rows_kernel_around_one_chunk(rng, cuda, D, dT):
    """T = L - 1, L and L + 1 for the kernel's chunk L (``gemm.rows_chunk``):
    one chunk ending in a partial tile, one whole chunk, and a second chunk
    of one token."""
    _rows_held_twice([a.to(cuda) for a in _rows_ops(rng, 6, gemm.rows_chunk() + dT, D)])


@pytest.mark.parametrize("BH,T,decay", [(1, 8192, "ordinary"), (80, 4096, "strong"),
                                        (80, 65536, "ordinary")])
def test_wkv6_rows_kernel_long_chains(cuda, BH, T, decay):
    """(1, 8192): one sequence, a chain of 128 chunks; rwkv_train's (80,
    4096) under strong decay (chunk products underflow to 0); (80, 65536):
    81,920 blocks, some 200 times what the card holds at once, which finish
    because a block waits only on a block that took its ticket earlier."""
    _rows_held_twice(_rows_ops_on(cuda, BH + T, BH, T, 64, decay))


@pytest.mark.parametrize("BH,T,D", [(5, 300, 64), (3, 70, 16)])
def test_wkv6_rows_binding_refuses_other_head_sizes(rng, cuda, BH, T, D):
    """Through the binding, the kernel against the plain version within
    1e-4 * max; a head size it was not built for (32) is refused at
    launch."""
    ops = [a.to(cuda) for a in _rows_ops(rng, BH, T, D)]
    want = ref.wkv6_rows_ref(*ops)
    got = gemm.key_rows("wkv6_rows", *ops)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    wide = [a.to(cuda) for a in _rows_ops(rng, BH, T, 32)]
    with pytest.raises(RuntimeError, match="launch failed"):
        gemm.key_rows("wkv6_rows", *wide)


@pytest.mark.parametrize("BH,T,words", [(80, 4096, 1 + 8 * 64 * 80),
                                        (3, 100, 1 + 8 * 2 * 3),
                                        (2, 20, 1 + 8 * 2)])
def test_rows_sync_words_are_a_ticket_and_a_flag_a_warp(cuda, BH, T, words):
    """The library's chunk length (64) and sync buffer for the key-row scan:
    the ticket, then 8 flags (one a consumer warp, at most 8) for each
    (chunk, sequence)."""
    assert gemm.rows_chunk() == 64
    assert gemm.rows_sync_words(BH, T) == words


def _recurrence64(r, k, v, logw, u, s0):
    """The token recurrence on (BH, T, D) operands in float64."""
    s, outs = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("bd,bdv->bv", r[:, t], s + u[:, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(outs, 1), s


@pytest.mark.parametrize("BH,T,D,chunk", [(8, 384, 64, 128), (6, 36, 16, 4),
                                          (3, 100, 64, 20), (4, 1, 64, 128)])
def test_wkv6_scan_backward_on_card_against_float64(rng, cuda, BH, T, D, chunk):
    """``wkv6_scan`` on the card (forward K6; backward one K6 launch on
    flipped operands and two key-row launches) against float64 autograd of
    the token recurrence on the same inputs, nonzero s0 and dS_T: each of
    the six gradients within 1e-4 of max|float64| (the CPU tests' bound,
    tests/test_torch_wkv6_grad.py).  T is a multiple of the chunk, as
    ``_wkv_chunked`` pads it; 36 and 100 end in a partial tile of the
    key-row kernel."""
    r, k, v, logw, u, s0 = _scan_ops(rng, BH, T, D)
    d_out, d_s = _rand(rng, BH, T, D), _rand(rng, BH, D, D, scale=0.1)
    ops64 = [a.double().requires_grad_() for a in (r, k, v, logw, u, s0)]
    o64, s64 = _recurrence64(*ops64)
    want = torch.autograd.grad((o64 * d_out.double()).sum()
                               + (s64 * d_s.double()).sum(), ops64)
    ops = [a.to(cuda).requires_grad_() for a in (r, k, v, logw, u, s0)]
    before = (wkv6_chunked.launches, wkv6_rows.launches)
    out, s_fin = wkv6_scan(*ops, chunk=chunk)
    got = torch.autograd.grad((out * d_out.to(cuda)).sum()
                              + (s_fin * d_s.to(cuda)).sum(), ops)
    torch.cuda.synchronize()
    assert (wkv6_chunked.launches, wkv6_rows.launches) == (before[0] + 2,
                                                           before[1] + 2)
    for name, g, w in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        assert bool(torch.isfinite(g).all()), name
        err = float((g.cpu().double() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


def test_rwkv_train_step_on_card_equals_cpu(rng, cuda):
    """One train step of the rwkv6_3b smoke model (fp32; 2 microbatches,
    remat, sequences of 30 padded to the chunk of 4) on the card against the
    same step on the CPU, with the bounds and the float64 rule of
    ``test_hybrid_train_step_on_card_equals_cpu`` (the CPU's time-mix scan
    is the plain chunked form, the card's the token recurrence).  K6 runs
    three times a layer and microbatch (remat's two forwards, the flipped
    launch of the backward), the key-row scan twice; no other kernel."""
    import dataclasses

    from repro_torch.launch.steps import TrainHParams, make_train_step
    from repro_torch.optim import adamw

    cfg = get_smoke_config("rwkv6_3b")
    hp = TrainHParams(optimizer=adamw.AdamWConfig(warmup_steps=2), microbatch=2)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    params_c = copy.deepcopy(params).to(cuda)
    params_64 = copy.deepcopy(params).to(torch.float64)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 30)))
             for k in ("tokens", "targets")}
    kernels = (grouped_block_diag_matmul, grouped_aug_gemm, grouped_row_gemm,
               block_diag_matmul, aug_gemm, wkv6_chunked, wkv6_rows)
    _, want_opt, want = make_train_step(cpu, hp)(
        params, adamw.init_state(params), batch)
    cfg_64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    _, opt_64, m_64 = make_train_step(Model(cfg_64, "cpu"), hp)(
        params_64, adamw.init_state(params_64), batch)
    before = [k.launches for k in kernels]
    _, opt, got = make_train_step(Model(cfg, "cuda"), hp)(
        params_c, adamw.init_state(params_c),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    per = cfg.n_layers * 2
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        0, 0, 0, 0, 0, 3 * per, 2 * per]
    assert int(opt["count"]) == 1

    def rel(a, b):
        return float((a.cpu().double() - b.double()).abs().max()
                     / b.double().abs().max())

    for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-5)):
        rtol = max(rtol, 4 * rel(want[k], m_64[k]))
        assert float(got[k]) == pytest.approx(float(want[k]), rel=rtol), k
    lr, opt_cfg = float(want["lr"]), hp.optimizer
    want_p = dict(adamw.named_leaves(params))
    for name, p in adamw.named_leaves(params_c):
        assert not p.requires_grad
        tols = {}
        for key, tol in (("m", 1e-4), ("v", 2e-4)):
            w = want_opt[key][name]
            tols[key] = max(tol, 4 * rel(w, opt_64[key][name]))
            assert rel(opt[key][name], w) <= tols[key], (key, name)
        g = want_opt["m"][name].double().abs() / (1 - opt_cfg.b1)
        decided = g >= 1e-2 * g.max()
        d = tols["m"] * g.max()
        diff = (p.cpu() - want_p[name]).abs().double()
        slack = 1e-6 * (float(want_p[name].abs().max()) + lr)
        moved = lr * opt_cfg.eps * d / (g[decided] * (g[decided] - d))
        assert bool((diff[decided] <= slack + moved).all()), name
        assert float(diff.max()) <= 2 * lr + slack, name


@pytest.mark.parametrize("S", [2, 40])
def test_recurrentgemma_smoke_model_on_card_equals_cpu(rng, cuda, S):
    """The recurrentgemma_2b smoke model (fp32; RG-LRU layers and local
    attention in a window of 8) on the card against the same weights on
    the CPU: forward logits within 1e-4 * max, then a prefill of S tokens
    (2: the conv state shorter than its width; 40: every ring wrapped) and
    three decode steps, both sides fed the CPU's greedy tokens, logits and
    every cache within 1e-4 * max; no kernel launched."""
    cfg = get_smoke_config("recurrentgemma_2b")
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    card = Model(cfg, "cuda")
    params_c = copy.deepcopy(params).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, S)))

    def close(got, want):
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= 1e-4 * float(want.float().abs().max()), err

    before = grouped_row_gemm.launches
    with torch.no_grad():
        close(stack.forward(params_c, cfg, tokens.to(cuda))[0],
              stack.forward(params, cfg, tokens)[0])
        lc, cc = cpu.prefill(params, {"tokens": tokens}, S + 4)
        lg, cg = card.prefill(params_c, {"tokens": tokens.to(cuda)}, S + 4)
        close(lg, lc)
        for t in range(S, S + 3):
            tok = torch.argmax(lc[:, 0], -1)[:, None]
            lc, cc = cpu.decode(params, tok, t, cc)
            lg, cg = card.decode(params_c, tok.to(cuda), t, cg)
            close(lg, lc)
        for c_card, c_cpu in zip(cg["blocks"], cc["blocks"]):
            for name in c_cpu:
                if name == "pos":
                    assert torch.equal(c_card[name].cpu(), c_cpu[name])
                else:
                    close(c_card[name], c_cpu[name])
    torch.cuda.synchronize()
    assert grouped_row_gemm.launches == before


def test_rec_block_at_full_width_on_card_equals_cpu(rng, cuda):
    """One RG-LRU mixer at recurrentgemma_2b's width (d 2560, 16 gate
    blocks of 160; random fp32 weights, the biases non-zero) on the card
    against the CPU: a prefill of 1024 positions (the doubling scan's 10
    steps), then two decode steps; outputs, the state ``h`` and the conv
    inputs within 1e-4 * max."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models.base import init_params

    cfg = dataclasses.replace(get_config("recurrentgemma_2b"),
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(5)
    p = init_params(blocks.schema_rec(cfg), torch.float32, gen, "cpu")
    p = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
         for k, v in p.items()}
    p_c = {k: v.to(cuda) for k, v in p.items()}
    cache = init_params(blocks.cache_rec(cfg, 1), torch.float32, None, "cpu")
    cache_c = {k: v.to(cuda, copy=True) for k, v in cache.items()}
    x = _rand(rng, 1, 1026, cfg.d_model)

    def close(got, want):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err

    full = blocks.RunState(mode="full", write_cache=True)
    want, _ = blocks.apply_rec(p, x[:, :1024], cfg, full, cache)
    got, _ = blocks.apply_rec(p_c, x[:, :1024].to(cuda), cfg, full, cache_c)
    close(got, want)
    for t in (1024, 1025):
        step = blocks.RunState(mode="decode", t=t)
        want, _ = blocks.apply_rec(p, x[:, t : t + 1], cfg, step, cache)
        got, _ = blocks.apply_rec(p_c, x[:, t : t + 1].to(cuda), cfg, step,
                                  cache_c)
        close(got, want)
        for name in ("h", "conv"):
            close(cache_c[name], cache[name])


def _doubling_as_written(a, b):
    """The RG-LRU's doubling scan as the forward computes it (a copy, so
    that a change of the library's forward shows as a change of bits)."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


@pytest.mark.parametrize("S", [37, 4096])
def test_linear_scan_on_card_against_cpu_and_float64(rng, cuda, S):
    """The RG-LRU's scan (``_LinearScan``: the doubling forward, the
    reverse scan as its backward) on the card, (2, S, 64) fp32, decays in
    [0.9, 1): the forward equals the doubling scan's bits on the card;
    the forward and the gradients of sum(w h) for a and b are within
    1e-5 of their max of the CPU's and of a float64 recurrence run one
    step at a time (the CPU tests hold the fp32 scan at 4096 steps within
    1e-5 of max of float64)."""
    from repro_torch.models import blocks

    a = torch.from_numpy(rng.uniform(0.9, 1.0, (2, S, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, S, 64)).astype(np.float32))

    def run(dev, dtype, scan):
        x, y = (t.to(dev, dtype).requires_grad_() for t in (a, b))
        with torch.enable_grad():
            h = scan(x, y)
            ga, gb = torch.autograd.grad((h * w.to(dev, dtype)).sum(), (x, y))
        return [t.detach().cpu().double() for t in (h, ga, gb)]

    def loop(x, y):
        hs, out = torch.zeros_like(y[:, 0]), []
        for t in range(x.shape[1]):
            hs = x[:, t] * hs + y[:, t]
            out.append(hs)
        return torch.stack(out, 1)

    ac, bc = a.to(cuda), b.to(cuda)
    assert torch.equal(blocks._linear_scan(ac, bc),
                       _doubling_as_written(ac, bc))
    card = run(cuda, torch.float32, blocks._linear_scan)
    for want in (run("cpu", torch.float32, blocks._linear_scan),
                 run("cpu", torch.float64, loop)):
        for got, wnt in zip(card, want):
            err = float((got - wnt).abs().max())
            assert err <= 1e-5 * float(wnt.abs().max()), err


def test_hybrid_train_step_on_card_equals_cpu(rng, cuda):
    """One train step of the recurrentgemma_2b smoke model (fp32; RG-LRU
    and local layers, tied scaled embeddings; 2 microbatches, remat, the
    windowed flash scan at 64 positions with blocks of 16) on the card
    against the same step on the CPU.  The bounds are the CPU tests' for
    the hybrid's step against the reference (tests/test_torch_train.py
    GRAD_TOLS, NORM_RTOLS), or four times the CPU step's own departure
    from the same step with the model in float64 where that is larger
    (the gates' sqrt(1 - a^2) amplifies fp32 rounding in their small
    gradients: the CPU's first moment of layer 1's gate_x departs by
    9.5e-4 of its max): loss within 1e-5 and grad_norm within 1.2e-4
    relative, the first moment within 1e-3 and the second within 2e-3 of
    their max, count 1; the parameters within 2 lr, and where the clipped
    gradient g = m / (1 - b1) is decided (|g| >= 1e-2 max|g|) within 1e-6
    of max|p| + lr plus what gradients d = (m's bound) max|g| apart move
    lr g / (|g| + eps): lr eps d / (|g| (|g| - d)) (``_hold_update``
    there); no kernel launched, no leaf left requiring grad."""
    import dataclasses

    from repro_torch.launch.steps import TrainHParams, make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_2b"),
                              dense_attn_max_seq=16, flash_block_kv=16)
    hp = TrainHParams(optimizer=adamw.AdamWConfig(warmup_steps=2), microbatch=2)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    params_c = copy.deepcopy(params).to(cuda)
    params_64 = copy.deepcopy(params).to(torch.float64)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
             for k in ("tokens", "targets")}
    kernels = (grouped_block_diag_matmul, grouped_aug_gemm, grouped_row_gemm,
               block_diag_matmul, aug_gemm, wkv6_chunked)
    before = [k.launches for k in kernels]
    _, want_opt, want = make_train_step(cpu, hp)(
        params, adamw.init_state(params), batch)
    cfg_64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    _, opt_64, m_64 = make_train_step(Model(cfg_64, "cpu"), hp)(
        params_64, adamw.init_state(params_64), batch)
    _, opt, got = make_train_step(Model(cfg, "cuda"), hp)(
        params_c, adamw.init_state(params_c),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    assert int(opt["count"]) == 1

    def rel(a, b):
        return float((a.cpu().double() - b.double()).abs().max()
                     / b.double().abs().max())

    for k, rtol in (("loss", 1e-5), ("grad_norm", 1.2e-4), ("lr", 1e-5)):
        rtol = max(rtol, 4 * rel(want[k], m_64[k]))
        assert float(got[k]) == pytest.approx(float(want[k]), rel=rtol), k
    lr, opt_cfg = float(want["lr"]), hp.optimizer
    want_p = dict(adamw.named_leaves(params))
    for name, p in adamw.named_leaves(params_c):
        assert not p.requires_grad
        tols = {}
        for key, tol in (("m", 1e-3), ("v", 2e-3)):
            w = want_opt[key][name]
            tols[key] = max(tol, 4 * rel(w, opt_64[key][name]))
            assert rel(opt[key][name], w) <= tols[key], (key, name)
        g = want_opt["m"][name].double().abs() / (1 - opt_cfg.b1)
        decided = g >= 1e-2 * g.max()
        d = tols["m"] * g.max()
        diff = (p.cpu() - want_p[name]).abs().double()
        slack = 1e-6 * (float(want_p[name].abs().max()) + lr)
        moved = lr * opt_cfg.eps * d / (g[decided] * (g[decided] - d))
        assert bool((diff[decided] <= slack + moved).all()), name
        assert float(diff.max()) <= 2 * lr + slack, name


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_lite_16b"])
def test_moe_smoke_model_on_card_equals_cpu(rng, cuda, arch):
    """The MoE smoke models (fp32; fine-grained MoE FFNs, and MLA for
    deepseek_v2_lite_16b) on the card against the same weights on the
    CPU: forward logits within 1e-4 * max, then a prefill and three decode
    steps of 3 rows, both sides fed the CPU's greedy tokens, logits within
    1e-4 * max at every step; no kernel launched (K3 belongs to the decode
    lane)."""
    cfg = get_smoke_config(arch)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    card = Model(cfg, "cuda")
    params_c = copy.deepcopy(params).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 12)))

    def close(got, want):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err

    before = grouped_row_gemm.launches
    with torch.no_grad():
        close(stack.forward(params_c, cfg, tokens.to(cuda))[0],
              stack.forward(params, cfg, tokens)[0])
        lc, cc = cpu.prefill(params, {"tokens": tokens}, 16)
        lg, cg = card.prefill(params_c, {"tokens": tokens.to(cuda)}, 16)
        close(lg, lc)
        for t in range(12, 15):
            tok = torch.argmax(lc[:, 0], -1)[:, None]
            lc, cc = cpu.decode(params, tok, t, cc)
            lg, cg = card.decode(params_c, tok.to(cuda), t, cg)
            close(lg, lc)
    torch.cuda.synchronize()
    assert grouped_row_gemm.launches == before


def test_train_step_on_card_equals_cpu(rng, cuda):
    """One train step of the deepseek_7b smoke model (fp32; 2 microbatches,
    remat, the flash scan at 64 positions with blocks of 16) on the card
    against the same step on the CPU: loss and grad_norm within 1e-5, both
    moments within 1e-4 (2e-4 for v) of their max (the fp32 gradients'
    rounding, as in tests/test_torch_train.py), count 1; the parameters
    within 1e-6 of max|p| + lr where |m| >= 1e-2 max|m| (the gradient's sign
    is decided there) and within 2 lr of that elsewhere; no kernel
    launched, and no leaf left requiring grad."""
    import dataclasses

    from repro_torch.launch.steps import TrainHParams, make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"),
                              dense_attn_max_seq=16, flash_block_kv=16)
    hp = TrainHParams(optimizer=adamw.AdamWConfig(warmup_steps=2), microbatch=2)
    cpu = Model(cfg, "cpu")
    params = cpu.init(0)
    params_c = copy.deepcopy(params).to(cuda)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
             for k in ("tokens", "targets")}
    kernels = (grouped_block_diag_matmul, grouped_aug_gemm, grouped_row_gemm,
               block_diag_matmul, aug_gemm, wkv6_chunked)
    before = [k.launches for k in kernels]
    _, want_opt, want = make_train_step(cpu, hp)(
        params, adamw.init_state(params), batch)
    _, opt, got = make_train_step(Model(cfg, "cuda"), hp)(
        params_c, adamw.init_state(params_c),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before
    assert int(opt["count"]) == 1
    for k in ("loss", "grad_norm", "lr"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    lr = float(want["lr"])
    want_p = dict(adamw.named_leaves(params))
    for name, p in adamw.named_leaves(params_c):
        assert not p.requires_grad
        for key, tol in (("m", 1e-4), ("v", 2e-4)):
            w = want_opt[key][name]
            err = float((opt[key][name].cpu() - w).abs().max())
            assert err <= tol * float(w.abs().max()), (key, name, err)
        m = want_opt["m"][name].abs()
        diff = (p.cpu() - want_p[name]).abs()
        slack = 1e-6 * (float(want_p[name].abs().max()) + lr)
        assert float(diff[m >= 1e-2 * m.max()].max()) <= slack, name
        assert float(diff.max()) <= 2 * lr + slack, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["identity", "out_of_order", "out_of_range"])
def test_k3_at_the_phi3_shape(cuda, dtype, name):
    """K3 at phi3_mini_3p8b's decode shape: h (4, 3072) against tables
    (6, 3072, 32064).  32064 = 31 x 1024 + 320, so the last 1,024-column
    strip is ragged; the whole output and that strip apart are held to the
    plain version: fp32 within 1e-4 * max|plain|, bf16 within two bf16
    ulps of max|plain|."""
    R, K, N = 4, 3072, 32064
    gen = torch.Generator(device=cuda).manual_seed(7)
    tables = torch.randn((6, K, N), generator=gen, device=cuda) * K ** -0.5
    h = torch.randn((R, K), generator=gen, device=cuda).to(dtype)
    gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32, device=cuda)
    want = ref.lm_head_rows_grouped_ref(h, gidx.clamp(0, 5), tables)
    before = grouped_row_gemm.launches
    got = grouped_row_gemm(h, gidx, tables)
    torch.cuda.synchronize()
    assert grouped_row_gemm.launches == before + 1
    _hold(got, want, dtype)
    last = N - N % 1024
    _hold(got[:, last:].contiguous(), want[:, last:].contiguous(), dtype)


def test_flash_attention_on_card_at_the_long_prompt_shape(cuda):
    """The port's flash scan (``models.layers.flash_attention``, plain
    torch ops) at (1, 2048, 32, 128) in bf16, the shape of one deepseek_7b
    layer on a 2048-token prompt, against an fp32 dense attention of the
    same bf16 inputs on the card: within twice the distance of bf16 dense
    attention from that fp32 result (the bound of ``chip_smoke.py``'s
    lm_long_prompt phase)."""
    from repro_torch.models import layers

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, 2048, 32, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    exact = layers.dense_attention(q.float(), k.float(), v.float())
    dense = layers.dense_attention(q, k, v)
    flash = layers.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.dtype == torch.bfloat16 and flash.shape == q.shape
    assert bool(torch.isfinite(flash).all())
    e_dense = float((dense.float() - exact).abs().max())
    e_flash = float((flash.float() - exact).abs().max())
    assert 0 < e_dense and e_flash <= 2 * e_dense, (e_flash, e_dense)


# -- K3 on bf16 tables, its split of K, its determinism ------------------------

K3_SHAPES = {"deepseek_7b": (4096, 102400), "phi3_mini_3p8b": (3072, 32064),
             "ragged_n999": (3000, 999), "ragged_n1000": (3000, 1000),
             "ragged_k": (129, 131), "deepseek_moe_16b": (2048, 102400),
             "moe_ragged_n": (2048, 1001),
             "recurrentgemma_2b": (2560, 256000)}


@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(K3_SHAPES))
def test_k3_bf16_tables_match_plain(cuda, shape, h_dtype):
    """K3 on bf16 tables (the decode lane's head stacks in a bf16 model)
    at both decode shapes and ragged ones, for every slot pattern and both
    h dtypes: against the plain version on the same tables (fp32 within
    1e-4 * max|plain|, bf16 two bf16 ulps of max|plain|), and bit for bit
    what K3 gives on the same entries held in fp32 (a bf16 entry is exact
    in fp32, and the warps split K alike for both table types)."""
    K, N = K3_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(11)
    t16 = (torch.randn((6, K, N), generator=gen, device=cuda)
           * K ** -0.5).to(torch.bfloat16)
    t32 = t16.float()
    h = torch.randn((4, K), generator=gen, device=cuda).to(h_dtype)
    for name in sorted(GIDX_CASES):
        gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32, device=cuda)
        want = ref.lm_head_rows_grouped_ref(h, gidx.clamp(0, 5), t16)
        before = grouped_row_gemm.launches
        got = grouped_row_gemm(h, gidx, t16)
        torch.cuda.synchronize()
        assert grouped_row_gemm.launches == before + 1
        _hold(got, want, h_dtype)
        assert torch.equal(got, grouped_row_gemm(h, gidx, t32)), name
    del t16, t32
    torch.cuda.empty_cache()


@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["phi3_mini_3p8b", "ragged_n999"])
def test_k3_gives_same_bits_twice(cuda, shape, h_dtype, t_dtype):
    """Two calls on the same operands give the same bits, on the 16-byte
    load form (phi3's shape) and the scalar one (N = 999): a block's warps
    add their sums in a fixed order, without atomics."""
    K, N = K3_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(12)
    tables = (torch.randn((6, K, N), generator=gen, device=cuda)
              * K ** -0.5).to(t_dtype)
    h = torch.randn((4, K), generator=gen, device=cuda).to(h_dtype)
    gidx = torch.tensor(GIDX_CASES["duplicates"], dtype=torch.int32,
                        device=cuda)
    first = grouped_row_gemm(h, gidx, tables)
    second = grouped_row_gemm(h, gidx, tables)
    torch.cuda.synchronize()
    bits = torch.int32 if h_dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


@pytest.mark.parametrize("N", [1024, 131])
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("slices", range(1, 9))
def test_k3_at_each_split_the_rule_picks(cuda, slices, t_dtype, N):
    """At K = 4 * slices - 3, ``gemm.row_splits`` gives K to ``slices``
    warps of the 8 (one short batch last, the rest idle), and at K = 4097
    to all 8 with a short last slice; K3 against its plain version there
    for the slot patterns with duplicates and clamps, on the 16-byte and
    the scalar load forms (bf16 and fp32 h)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    for K in (4 * slices - 3, 4097):
        _, kslice = gemm.row_splits(4, K, N, t_dtype.itemsize)
        assert -(-K // kslice) == (slices if K < 4097 else 8)
        tables = (torch.randn((6, K, N), generator=gen, device=cuda)
                  * K ** -0.5).to(t_dtype)
        for h_dtype in (torch.bfloat16, torch.float32):
            h = torch.randn((4, K), generator=gen, device=cuda).to(h_dtype)
            for name in ("duplicates", "out_of_range"):
                gidx = torch.tensor(GIDX_CASES[name], dtype=torch.int32,
                                    device=cuda)
                got = grouped_row_gemm(h, gidx, tables)
                _hold(got, ref.lm_head_rows_grouped_ref(
                    h, gidx.clamp(0, 5), tables), h_dtype)


def _same_bits(a, b):
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def test_param_tree_restored_in_place_on_card(cuda, tmp_path):
    """A bf16 ParamTree and its AdamW state on the card, saved, changed in
    place, then ``restore_into``: every leaf holds the saved bits in the
    storage it had."""
    import dataclasses

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke_config("phi3_mini_3p8b"),
                              dtype="bfloat16", param_dtype="bfloat16")
    params = Model(cfg, cuda).init(0)
    state = {"params": params, "opt": adamw.init_state(params)}
    with torch.no_grad():
        for leaf in tree_leaves(state["opt"]):
            leaf.add_(1)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(2, state, extra={"data": {"index": 2}})
    saved = [leaf.detach().clone() for leaf in tree_leaves(state)]
    ptrs = [leaf.data_ptr() for leaf in tree_leaves(state)]
    with torch.no_grad():
        for leaf in tree_leaves(state):
            leaf.mul_(3).add_(1)
    ckpt.wait()
    assert ckpt.restore_into(2, state) == {"data": {"index": 2}}
    leaves = tree_leaves(state)
    assert [leaf.data_ptr() for leaf in leaves] == ptrs
    assert all(leaf.is_cuda for leaf in leaves)
    assert params["embed"].dtype == torch.bfloat16
    assert all(_same_bits(a.detach(), b) for a, b in zip(leaves, saved))


def test_resilient_loop_on_card_through_one_failure(cuda, tmp_path):
    """The phi3_mini_3p8b smoke model in bf16 on the card through
    ``launch/train.py``: a failure at step 5 restores step 4's checkpoint,
    and the run ends with the clean run's losses, parameters and moments
    bit for bit (the same ops on the same card)."""
    import dataclasses

    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_smoke_config("phi3_mini_3p8b"),
                              dtype="bfloat16", param_dtype="bfloat16")
    argv = ["--arch", "phi3_mini_3p8b", "--mole", "token", "--seq-len", "64",
            "--batch", "4", "--microbatch", "2", "--steps", "8",
            "--ckpt-every", "4", "--device", "cuda"]
    clean, clean_hist = train.main(
        argv + ["--ckpt-dir", str(tmp_path / "clean")], cfg=cfg)
    faulty, hist = train.main(argv + ["--ckpt-dir", str(tmp_path / "faulty"),
                                      "--inject-failures", "5"], cfg=cfg)
    assert [h["event"] for h in hist if "event" in h] == [
        "restored@4: injected failure at step 5"]
    losses = {h["step"]: float(h["loss"]) for h in hist if "loss" in h}
    assert losses == {h["step"]: float(h["loss"])
                      for h in clean_hist if "loss" in h}
    assert all(leaf.is_cuda for leaf in tree_leaves(faulty))
    assert all(_same_bits(a.detach(), b.detach()) for a, b in
               zip(tree_leaves(faulty), tree_leaves(clean)))


def test_k3_last_strip_of_a_command_r_stack(cuda):
    """K3 at command_r_35b's decode shape on a 2-slot bf16 stack: h (4,
    8192) bf16 against tables (2, 8192, 256000), 8.4 GB.  The second slot
    starts 2,097,152,000 entries in and ends past 2^31, so its offsets need
    64 bits.  The whole output within two bf16 ulps of max|plain|, and the
    last strip of 256 columns of the rows on the last slot also against a
    float64 product of the same entries."""
    R, K, N = 4, 8192, 256000
    gen = torch.Generator(device=cuda).manual_seed(8)
    tables = torch.randn((2, K, N), generator=gen, device=cuda,
                         dtype=torch.bfloat16)
    tables.mul_(K ** -0.5)
    h = torch.randn((R, K), generator=gen, device=cuda).to(torch.bfloat16)
    gidx = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=cuda)
    want = ref.lm_head_rows_grouped_ref(h, gidx, tables)
    before = grouped_row_gemm.launches
    got = grouped_row_gemm(h, gidx, tables)
    torch.cuda.synchronize()
    assert grouped_row_gemm.launches == before + 1
    _hold(got, want, torch.bfloat16)
    cols = slice(N - 256, N)
    rows = [0, 2, 3]
    # slot 1, row k of the table, starts at entry (K + k) N: past 2^31
    assert (K + K - 1) * N > 2 ** 31
    exact = h[rows].double() @ tables[1][:, cols].double()
    _hold(got[rows, cols].contiguous(), want[rows, cols].contiguous(),
          torch.bfloat16)
    err = float((got[rows, cols].double() - exact).abs().max())
    scale = float(exact.abs().max())
    assert err <= 2 * 2.0 ** (np.floor(np.log2(scale)) - 7), (err, scale)
    del tables
    torch.cuda.empty_cache()


def test_gemma2_smoke_lane_on_card_equals_cpu(cuda, monkeypatch):
    """The gemma2_27b smoke model (fp32, window 8) served by the decode lane
    on the card and on the CPU with the same weights and tenants: 6
    requests on 2 rows, prompts of 8 and up to 8 generated, so every local
    layer's ring wraps and rows re-join.  K3 runs once a decode step on the
    card.  Every step's logits agree within 1e-4 * max, and the
    generations are equal, up to a step where the CPU's top-2 gap is
    itself within that bound (a near-tie the two machines may break
    apart)."""
    import repro_torch.launch.steps as steps
    from repro_torch.core.lm import LMSessionRegistry
    from repro_torch.runtime import ContinuousDecodeLane

    cfg = get_smoke_config("gemma2_27b")
    params = Model(cfg, "cpu").init(0)
    embed = params["embed"].numpy()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
               for _ in range(6)]
    gens = [8, 3, 6, 8, 2, 5]

    def serve(device, p):
        reg = LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=6)
        for i in range(6):
            reg.register(f"t{i}", embed, seed=20 + i)
        lane = ContinuousDecodeLane(Model(cfg, device), p, reg, rows=2,
                                    max_len=24, device=device)
        seen, real = [], steps.lm_head_rows_grouped
        monkeypatch.setattr(steps, "lm_head_rows_grouped",
                            lambda *a: seen.append(real(*a)) or seen[-1])
        sids = [lane.submit(f"t{i}", prompts[i], gens[i]) for i in range(6)]
        before = grouped_row_gemm.launches
        lane.run()
        monkeypatch.undo()
        return ([s.float().cpu() for s in seen],
                [lane.take(s) for s in sids], grouped_row_gemm.launches - before)

    want_lg, want, _ = serve("cpu", params)
    got_lg, got, launches = serve(cuda, copy.deepcopy(params).to(cuda))
    assert launches == len(got_lg) >= max(gens) - 1
    for a, b in zip(got_lg, want_lg):
        scale = float(b.abs().max())
        top2 = b.topk(2, dim=-1).values
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            assert float((top2[:, 0] - top2[:, 1]).min()) <= 1e-4 * scale
            break
        assert float((a - b).abs().max()) <= 1e-4 * scale
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_k4_at_the_vlm_provider_shape(cuda):
    """K4 at the provider's patch morph of ``llama32_vision_90b`` training
    (``--mole embedding``, kappa 1): two sequences of 1024 patches of 7680,
    (2048, 7680) rows x one (7680, 7680) core.  fp32, against its plain
    version within 1e-4 of max|plain| and against a float64 product of its
    first 512 columns within 1e-5 of max|fp64|; one launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2048, 7680, generator=gen, device=cuda)
    core = torch.randn(7680, 7680, generator=gen, device=cuda) * 7680 ** -0.5
    before = block_diag_matmul.launches
    got = morph_rows(x, core, 1)
    assert block_diag_matmul.launches == before + 1
    want = ref.block_diag_matmul_ref(x, core, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    exact = torch.matmul(x.double(), core[:, :512].double())
    assert (float((got[:, :512].double() - exact).abs().max())
            <= 1e-5 * float(exact.abs().max()))


def test_provider_stage_launches_k4_on_the_card(cuda):
    """``Pipeline`` with ``--mole embedding`` (kappa 4) on a CUDA device:
    the patches are morphed by K4 (one launch a batch) and stay on the
    card; the tokens are the CPU pipeline's, the patches within 1e-5 of
    max|plain| of its plain morph."""
    import dataclasses

    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models.base import MoLeCfg

    cfg = dataclasses.replace(
        get_smoke_config("llama32_vision_90b"),
        mole=MoLeCfg(enabled=True, mode="embedding", kappa=4, seed=5))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    on_cpu = Pipeline(data, model_cfg=cfg, device="cpu")
    on_card = Pipeline(data, model_cfg=cfg, device=cuda)
    for _ in range(2):
        before = block_diag_matmul.launches
        got, want = next(on_card), next(on_cpu)
        assert block_diag_matmul.launches == before + 1
        assert got["patches"].device.type == "cuda"
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        scale = float(want["patches"].abs().max())
        assert float((got["patches"].cpu() - want["patches"]).abs().max()) \
            <= 1e-5 * scale


def test_k4_at_the_whisper_provider_shape(cuda):
    """K4 at the provider's frame morph of ``whisper_tiny`` training
    (``--mole embedding``, kappa 1): 16 sequences of 1500 frames of 384,
    (24000, 384) rows x one (384, 384) core.  fp32, against its plain
    version within 1e-4 of max|plain| and against a float64 product within
    1e-5 of max|fp64|; one launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(24000, 384, generator=gen, device=cuda)
    core = torch.randn(384, 384, generator=gen, device=cuda) * 384 ** -0.5
    before = block_diag_matmul.launches
    got = morph_rows(x, core, 1)
    assert block_diag_matmul.launches == before + 1
    want = ref.block_diag_matmul_ref(x, core, 1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    exact = torch.matmul(x.double(), core.double())
    assert (float((got.double() - exact).abs().max())
            <= 1e-5 * float(exact.abs().max()))


def test_provider_stage_launches_k4_on_frames(cuda):
    """``Pipeline`` of ``whisper_tiny`` (smoke) with ``--mole embedding``
    (kappa 4) on a CUDA device: the frames are morphed by K4 (one launch a
    batch) and stay on the card; the tokens are the CPU pipeline's, the
    frames within 1e-5 of max|plain| of its plain morph."""
    import dataclasses

    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models.base import MoLeCfg

    cfg = dataclasses.replace(
        get_smoke_config("whisper_tiny"),
        mole=MoLeCfg(enabled=True, mode="embedding", kappa=4, seed=5))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    on_cpu = Pipeline(data, model_cfg=cfg, device="cpu")
    on_card = Pipeline(data, model_cfg=cfg, device=cuda)
    for _ in range(2):
        before = block_diag_matmul.launches
        got, want = next(on_card), next(on_cpu)
        assert block_diag_matmul.launches == before + 1
        assert "patches" not in got and got["frames"].device.type == "cuda"
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        scale = float(want["frames"].abs().max())
        assert float((got["frames"].cpu() - want["frames"]).abs().max()) \
            <= 1e-5 * scale


# -- K4's fp32 route: aug_gemm.cu's split-TF32 GEMM, split K ----------------

def _fp64_rel(got, a, b):
    """max|got - a @ b in float64| over max|float64|, (G, M, K) @ (G, K, N)."""
    want = torch.bmm(a.double(), b.double())
    return float((got.double() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("G,M,q", [(1, 256, 3072), (1, 24000, 384), (1, 111, 100),
                                   (3, 70, 70), (2, 9, 130), (1, 130, 384),
                                   (1, 8192, 960)])
def test_k4_fp32_route_holds_fp64_bound(rng, cuda, G, M, q):
    """K4 in fp32 through its wrapper (the split-TF32 GEMM at the rule's
    split), at VGG-16's and whisper's shapes and ragged or unaligned ones:
    within 1e-5 of max|fp64| and 1e-4 of max|plain|; one launch each."""
    a = _rand(rng, G, M, q).to(cuda)
    b = _rand(rng, G, q, q, scale=q ** -0.5).to(cuda)
    before = block_diag_matmul.launches
    got = block_diag_matmul(a, b, 1)
    torch.cuda.synchronize()
    assert block_diag_matmul.launches == before + 1
    assert _fp64_rel(got, a, b) <= 1e-5
    _hold(got, ref.block_diag_matmul_batched_ref(a, b, 1), torch.float32)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
def test_k4_fp32_every_split_at_vgg(rng, cuda, splits):
    """The split-TF32 GEMM at VGG-16's K4 shape through its binding at a
    range of splits (the slices' partials added in slice order): within
    1e-5 of max|fp64|, and the same bits on two calls."""
    a = _rand(rng, 1, 256, 3072).to(cuda)
    b = _rand(rng, 1, 3072, 3072, scale=3072 ** -0.5).to(cuda)
    first = gemm.morph_tf32("block_diag_matmul", a, b, splits)
    second = gemm.morph_tf32("block_diag_matmul", a, b, splits)
    torch.cuda.synchronize()
    assert _fp64_rel(first, a, b) <= 1e-5
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_k4_fp32_route_gives_same_bits_twice(rng, cuda):
    """K4 through its wrapper at VGG-16's shape (split by the rule) and at
    whisper's (one slice): two calls, the same bits."""
    for M, q in ((256, 3072), (24000, 384)):
        x = _rand(rng, M, q).to(cuda)
        core = _rand(rng, q, q, scale=q ** -0.5).to(cuda)
        first, second = block_diag_matmul(x, core, 1), block_diag_matmul(x, core, 1)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_k4_fp32_refuses_an_empty_slice_on_card(rng, cuda):
    """A split that would leave a slice empty is refused by the binding
    before any launch."""
    a = _rand(rng, 1, 8, 100).to(cuda)
    b = _rand(rng, 1, 100, 16).to(cuda)
    with pytest.raises(ValueError, match="leave one empty"):
        gemm.morph_tf32("block_diag_matmul", a, b, 5)


# -- K6's time-chunked form ---------------------------------------------------

@pytest.mark.parametrize("BH,T,D", [(4, 100, 16), (3, 20, 64), (2, 300, 64),
                                    (5, 257, 16), (40, 1024, 64)])
def test_wkv6_chunk_form_every_length(rng, cuda, BH, T, D):
    """The time-chunked form at every chunk length it takes, through the
    binding: T a multiple of none, T below L, both head sizes; out and final
    state against the token recurrence within 1e-4 of max.  A length it
    does not take (40: not whole tiles of 16) is refused at launch."""
    ops = [a.to(cuda) for a in _scan_ops(rng, BH, T, D)]
    for L in gemm.SCAN_CHUNKS:
        got_o, got_s = gemm.scan("wkv6_chunked", *ops, tokens=L)
        _scan_vs_recurrence(ops, got_o, got_s)
    with pytest.raises(RuntimeError, match="launch failed"):
        gemm.scan("wkv6_chunked", *ops, tokens=40)


@pytest.mark.parametrize("BH,T,L,words", [(80, 4096, 64, 1 + 8 * 64 * 80),
                                          (3, 100, 32, 1 + 8 * 4 * 3),
                                          (2, 20, 256, 1 + 8 * 2)])
def test_chunk_sync_words_are_a_ticket_and_a_flag_a_warp(cuda, BH, T, L, words):
    """The library's sync buffer for the time-chunked form: the ticket, then
    8 flags (one a consumer warp, at most 8) for each (chunk, sequence)."""
    assert gemm.scan_sync_words(BH, T, L) == words


@pytest.mark.parametrize("decay", ["ordinary", "strong", "none"])
def test_wkv6_at_the_train_shape(rng, cuda, decay):
    """K6 through its wrapper at rwkv_train's (80, 4096, 64), in the form
    the rule takes there (the time-chunked one), against the token
    recurrence within 1e-4 of max: logw = -exp(N), -exp(2 N) (every chunk's
    product underflows) and 0 (the state only grows); the same bits twice."""
    r, k, v, logw, u, s0 = (a.to(cuda) for a in _scan_ops(rng, 80, 4096, 64))
    z = logw if decay == "ordinary" else _rand(rng, 80, 4096, 64).to(cuda)
    logw = {"ordinary": logw, "strong": -torch.exp(2 * z),
            "none": torch.zeros_like(z)}[decay]
    ops = (r, k, v, logw, u, s0)
    assert gemm.scan_form(80, 4096, 64, gemm.sm_count(cuda))[0] == "chunks"
    got_o, got_s = wkv6_chunked(*ops, chunk=128)
    again_o, again_s = wkv6_chunked(*ops, chunk=128)
    _scan_vs_recurrence(ops, got_o, got_s)
    assert torch.equal(got_o.view(torch.int32), again_o.view(torch.int32))
    assert torch.equal(got_s.view(torch.int32), again_s.view(torch.int32))


def test_wkv6_chunk_form_backward_against_float64(rng, cuda, monkeypatch):
    """``wkv6_scan``'s gradient with both K6 launches (the forward and the
    backward's on flipped operands) in the time-chunked form, at (8, 1000,
    64) with L = 64 forced through the rule: the six gradients within 1e-4
    of max|float64| of the token recurrence's autograd."""
    ops = [a.to(cuda) for a in _scan_ops(rng, 8, 1000, 64)]
    d_out = _rand(rng, 8, 1000, 64).to(cuda)
    d_s = _rand(rng, 8, 64, 64, scale=0.1).to(cuda)
    monkeypatch.setattr(gemm, "scan_form", lambda *a: ("chunks", 64))
    xs = [a.clone().requires_grad_() for a in ops]
    before = wkv6_chunked.launches
    out, s_fin = wkv6_scan(*xs, chunk=40)
    grads = torch.autograd.grad((out, s_fin), xs, (d_out, d_s))
    assert wkv6_chunked.launches == before + 2
    x64 = [a.double().requires_grad_() for a in ops]
    o, s = ref.wkv6_ref(*(a[None] for a in x64[:4]), x64[4], x64[5][None])
    want = torch.autograd.grad((o[0], s[0]), x64, (d_out.double(), d_s.double()))
    for g, w in zip(grads, want):
        assert float((g.double() - w).abs().max()) <= 1e-4 * float(w.abs().max())
