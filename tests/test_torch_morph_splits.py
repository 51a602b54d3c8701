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

from repro_torch.kernels import gemm  # noqa: E402

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
