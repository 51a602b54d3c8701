"""The split rule of the morph kernel (K1/K4, ``csrc/morph_gemm.cu``), held
on the CPU through its wrapper ``kernels/gemm.py::morph`` with the launch
replaced by a recorder: what the kernel would be handed (its split, its
slice length, its workspace) is checked for every shape, and the rule
``morph_splits`` is a pure function of the shape and the SM count.

The kernel sums slice j over ``[j * kslice, min(K, (j + 1) * kslice))``
(``morph_gemm.cu``, ``k_begin``/``k_end``), so "every slice non-empty,
BK-aligned but the last, covering K once" is ``kslice % BK == 0`` and
``(splits - 1) * kslice < K <= splits * kslice``.  The card tests in
``tests/test_torch_cuda.py`` hold the kernel's sums themselves.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import block_diag_matmul, gemm, ref  # noqa: E402

BK = gemm.MORPH_BK
SHAPES = [                      # (G, M, N, K)
    (1, 256, 3072, 3072),       # K4 at VGG-16/CIFAR width (vgg_path)
    (4, 64, 3072, 3072),        # K1 on the engine's main path
    (4, 256, 768, 768),         # K1 at kappa = 4
    (4, 9, 1000, 1000),         # K1 ragged
    (3, 20, 130, 130),
    (2, 5, 10, 10),             # K < BK
    (1, 64, 256, 255),
    (1, 1024, 960, 960),        # K4 at (1024, 8, 960)
    (4, 64, 65536, 3072),       # tiles alone fill the card
]
SMS = [1, 78, 132]


class _TorchSpy:
    """``torch`` as ``gemm`` sees it, recording every tensor it allocates."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, **kwargs):
        t = torch.empty(*args, **kwargs)
        self.made.append(t)
        return t


def _launch(monkeypatch, G, M, N, K, *, slots=None, splits=None, sms=132,
            dtype=torch.float32):
    """Run ``gemm.morph`` on CPU operands of the shape (broadcast views, no
    data) with the launch recorded instead of made; returns the launch's
    (symbol, splits, kslice, ws_ptr), the output and the tensors the
    wrapper allocated."""
    calls, spy = [], _TorchSpy()
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "sm_count", lambda device: sms)
    monkeypatch.setattr(gemm, "torch", spy)
    a = torch.zeros((), dtype=dtype).expand(G, M, K)
    b = torch.zeros((), dtype=dtype).expand(slots or G, K, N)
    gidx = None if slots is None else torch.zeros(G, dtype=torch.int32)
    out = gemm.morph("morph", a, gidx, b, splits)
    (args,) = calls
    ws_ptr = args[6] if slots is None else args[7]
    return (args[1], args[-2], args[-1], ws_ptr), out, spy.made


@pytest.mark.parametrize("slot_indexed", [False, True], ids=["K4", "K1"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("G,M,N,K", SHAPES)
def test_slices_cover_k_exactly(monkeypatch, G, M, N, K, sms, slot_indexed):
    """The wrapper's default split is the rule's, at least 1; the slice
    length it hands the kernel is BK-aligned and leaves every slice
    non-empty and K covered once; the workspace is one fp32 (G, M, N) per
    slice, none (a null pointer) for one slice."""
    (symbol, s, kslice, ws_ptr), out, made = _launch(
        monkeypatch, G, M, N, K, slots=6 if slot_indexed else None, sms=sms)
    assert symbol == ("morph_sgemm" if slot_indexed else "morph_gemm_typed")
    assert s == gemm.morph_splits(G, M, N, K, sms) >= 1
    assert kslice > 0 and kslice % BK == 0
    assert (s - 1) * kslice < K <= s * kslice
    assert out.shape == (G, M, N) and out.dtype == torch.float32
    ws = [t for t in made if t is not out]
    if s == 1:
        assert ws == [] and ws_ptr is None
    else:
        (w,) = ws
        assert w.dtype == torch.float32 and w.shape == (s, G, M, N)
        assert ws_ptr == w.data_ptr()


@pytest.mark.parametrize("K", [1, 15, 16, 100, 255])
def test_short_k_is_one_slice(K):
    """K < 256, two slices of 8 k-steps of 16: no split, however empty the
    card."""
    assert gemm.morph_splits(1, 64, 128, K, 132) == 1


@pytest.mark.parametrize("G,M,N,sms", [(4, 64, 65536, 132), (1, 1024, 8192, 132),
                                       (1, 64, 384, 1)])
def test_no_split_where_tiles_fill_the_card(G, M, N, sms):
    """Three 64 x 128 tiles per SM (the kernel's resident blocks) or more:
    the tiles fill the card by themselves."""
    assert G * -(-M // 64) * -(-N // 128) >= 3 * sms
    assert gemm.morph_splits(G, M, N, 3072, sms) == 1


@pytest.mark.parametrize("G,M", [(1, 256), (4, 64)])
def test_main_shapes_fill_an_h100(monkeypatch, G, M):
    """K4 (256 rows) and K1 (4 x 64 rows) at q = 3072 on 132 SMs: 96 tiles
    split 4 ways, 384 blocks, so most SMs hold three (12 warps); each slice
    is 768 long."""
    (_, s, kslice, _), _, _ = _launch(monkeypatch, G, M, 3072, 3072, sms=132)
    assert s == 4 and kslice == 768
    assert G * (M // 64) * (3072 // 128) * s == 384


@pytest.mark.parametrize("K,splits", [(10, 2), (100, 0), (100, 8), (3072, 193)])
def test_morph_refuses_an_empty_slice(monkeypatch, K, splits):
    """A split given to the wrapper that would leave a slice empty (or no
    slice at all) raises before any launch."""
    with pytest.raises(ValueError, match="leave one empty"):
        _launch(monkeypatch, 1, 8, 16, K, splits=splits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_given_split_is_passed_through(monkeypatch, dtype):
    """An explicit split overrides the rule (the chip smoke's sweep); the
    output keeps the operand dtype, the workspace stays fp32."""
    (symbol, s, kslice, _), out, made = _launch(
        monkeypatch, 1, 256, 3072, 3072, splits=3, dtype=dtype)
    assert (symbol, s, kslice) == ("morph_gemm_typed", 3, 1024)
    assert out.dtype == dtype
    assert [t.shape for t in made if t is not out] == [(3, 1, 256, 3072)]
    assert all(t.dtype == torch.float32 for t in made if t is not out)


# -- K4's fp32 route: aug_gemm.cu's split-TF32 GEMM, split by tf32_splits ----

TF32_SHAPES = [                 # (G, M, N, K)
    (1, 256, 3072, 3072),       # K4 at VGG-16/CIFAR width (vgg_path)
    (1, 2048, 7680, 7680),      # K4 at the vlm provider's morph (vlm_train)
    (1, 24000, 384, 384),       # K4 at whisper's frame morph (whisper_train)
    (1, 768, 1024, 1024),       # K4 at (256, 3, 1024)
    (1, 8192, 960, 960),        # K4 at (1024, 8, 960)
    (1, 111, 100, 100),         # K4 ragged
    (4, 64, 3072, 3072),        # one core per group
    (2, 5, 10, 10),             # K < one stage
]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("G,M,N,K", TF32_SHAPES)
def test_tf32_splits_are_valid_and_pure(G, M, N, K, sms):
    """Every shape gets a split the kernel takes: at least 1, every slice
    of ceil(ceil(K / 32) / s) stages non-empty, G * s within the grid; the
    rule is a pure function (memoised, the same answer again)."""
    s = gemm.tf32_splits(G, M, N, K, sms)
    steps = -(-K // gemm.TF32_BK)
    per = -(-steps // s)
    assert s >= 1 and (s - 1) * per < steps and G * s <= gemm.MAX_GRID_YZ
    gemm.tf32_splits.cache_clear()
    assert gemm.tf32_splits(G, M, N, K, sms) == s


@pytest.mark.parametrize("G,M,N,K,tiles", [(1, 2048, 7680, 7680, 960),
                                           (1, 24000, 384, 384, 564)])
def test_tf32_one_slice_where_tiles_fill_the_card(G, M, N, K, tiles):
    """The vlm provider's morph (960 tiles of 128 x 128) and whisper's (564)
    give every one of 132 SMs a tile by themselves: one slice, no partial
    sums, one GEMM launch after the split."""
    assert gemm._tf32_tiles(G, M, N) == tiles >= 132
    assert gemm.tf32_splits(G, M, N, K, 132) == 1


def test_tf32_splits_fill_an_h100_at_vgg():
    """VGG-16's K4, (256, 3072) @ (3072, 3072): 48 tiles on 132 SMs.  The
    rule splits K so that every SM gets a block (one fits an SM), each
    slice a whole number of 32-k stages."""
    tiles = gemm._tf32_tiles(1, 256, 3072)
    s = gemm.tf32_splits(1, 256, 3072, 3072, 132)
    assert tiles == 48 and s > 1 and tiles * s >= 132


@pytest.mark.parametrize("G,M,N,K", TF32_SHAPES)
def test_k4_routes(G, M, N, K):
    """fp32 products of at least 3 GFLOP (every main path's: VGG-16's 4.8,
    whisper's 7.1, the vlm provider's 242) take the split-TF32 GEMM; smaller
    fp32 ones and bf16 the FFMA morph kernel."""
    big = 2 * G * M * N * K >= 3e9
    assert gemm.morph_route(torch.float32, G, M, N, K) == ("tf32" if big else "ffma")
    assert gemm.morph_route(torch.bfloat16, G, M, N, K) == "ffma"
    if (M, N) in ((256, 3072), (2048, 7680), (24000, 384)):
        assert big


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _CardSpy(_TorchSpy):
    """``_TorchSpy`` allocating on the CPU what the binding asks for on the
    card."""

    def empty(self, *args, device=None, **kwargs):
        return super().empty(*args, **kwargs)


def _library_floats(G, M, K):
    """Stands in for the library's ``aug_workspace_floats``."""
    return 1000 * G + 10 * M + K + 7


@pytest.fixture
def card(monkeypatch):
    """Launches recorded, 132 SMs, the workspace query answered, the plain
    versions refused; returns (calls, the tensors the binding allocated)."""
    calls, spy = [], _CardSpy()
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "sm_count", lambda device: 132)
    monkeypatch.setattr(gemm, "_entry", lambda symbol: (
        (lambda *a: _library_floats(*a)), None))
    monkeypatch.setattr(gemm, "torch", spy)

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA request reached the plain version")
    for plain in ("block_diag_matmul_ref", "block_diag_matmul_batched_ref"):
        monkeypatch.setattr(ref, plain, no_plain)
    return calls, spy.made


@pytest.mark.parametrize("lead,R,kappa,q", [((), 256, 1, 3072), ((), 2048, 1, 7680),
                                            ((), 24000, 1, 384), ((), 1024, 8, 960),
                                            ((4,), 64, 1, 3072)])
def test_k4_fp32_hands_the_split_kernel_its_operands(card, lead, R, kappa, q):
    """K4 in fp32: one ``aug_sgemm_split`` call with x's, the core's, the
    output's and the two workspaces' pointers (the split x of the library's
    size; the slices' fp32 (s, G, M, N) partials where s > 1, else a null
    pointer), G, M = R * kappa, N = K = q and the rule's split; counted."""
    calls, made = card
    G = lead[0] if lead else 1
    x = torch.zeros(*lead, R, kappa * q).as_subclass(_OnCard)
    core = torch.zeros(*lead, q, q).as_subclass(_OnCard)
    before = block_diag_matmul.launches
    out = block_diag_matmul(x, core, kappa)
    (args,) = calls
    assert block_diag_matmul.launches == before + 1
    M = R * kappa
    s = gemm.tf32_splits(G, M, q, q, 132)
    assert args[:2] == ("block_diag_matmul", "aug_sgemm_split")
    assert args[3:6] == (x.data_ptr(), core.data_ptr(), out.data_ptr())
    assert args[8:] == (G, M, q, q, s)
    ws = [t for t in made if t.data_ptr() == args[6]]
    assert len(ws) == 1 and ws[0].numel() == _library_floats(G, M, q)
    if s == 1:
        assert args[7] is None
    else:
        (part,) = [t for t in made if t.data_ptr() == args[7]]
        assert part.dtype == torch.float32 and part.shape == (s, G, M, q)
    assert out.shape == x.shape and out.dtype == torch.float32


@pytest.mark.parametrize("dtype,R,kappa,q", [(torch.bfloat16, 256, 1, 3072),
                                             (torch.float32, 256, 3, 1024),
                                             (torch.float32, 37, 3, 100)])
def test_k4_ffma_route(card, dtype, R, kappa, q):
    """K4 in bf16, and small fp32 products: one ``morph_gemm_typed`` call,
    split by ``morph_splits``."""
    calls, _ = card
    x = torch.zeros(R, kappa * q, dtype=dtype).as_subclass(_OnCard)
    core = torch.zeros(q, q, dtype=dtype).as_subclass(_OnCard)
    block_diag_matmul(x, core, kappa)
    (args,) = calls
    assert args[:2] == ("block_diag_matmul", "morph_gemm_typed")
    assert args[-2] == gemm.morph_splits(1, R * kappa, q, q, 132)


@pytest.mark.parametrize("K,splits", [(10, 2), (100, 0), (100, 5), (3072, 97)])
def test_morph_tf32_refuses_an_empty_slice(card, K, splits):
    """A split given to the binding that would leave a slice of 32-k stages
    empty (or no slice at all) raises before any launch."""
    calls, _ = card
    a = torch.zeros(1, 8, K).as_subclass(_OnCard)
    b = torch.zeros(1, K, 16).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="leave one empty"):
        gemm.morph_tf32("block_diag_matmul", a, b, splits)
    assert calls == []
