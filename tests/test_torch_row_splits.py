"""The split of K3's work (``csrc/row_gemm.cu``), and what its binding hands
the kernel, held on the CPU: ``grouped_row_gemm`` runs its kernel branch on
CPU tensors that report a CUDA device, with ``gemm._call`` recorded instead
of launched (as ``tests/test_torch_split_tf32.py`` does for K2/K5).

A block takes one row and one strip of 512 table bytes a table row, so the
grid is ``(strips, R)``; its 8 warps sum slice w of K over ``[w * kslice,
min(K, (w + 1) * kslice))`` (``row_gemm.cu``, ``k0``/``k1``), so "every
slice non-empty, whole batches of 4 but the last, covering K once" is
``kslice % 4 == 0`` and ``(slices - 1) * kslice < K <= slices * kslice``
with ``slices = ceil(K / kslice) <= 8``.  The card tests in
``tests/test_torch_cuda.py`` hold the kernel's sums themselves.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gemm, grouped_row_gemm, ref  # noqa: E402

WARPS, BATCH = 8, 4
MAIN = {"deepseek_7b": (4, 4096, 102400), "phi3_mini_3p8b": (4, 3072, 32064)}
SHAPES = [                          # (R, K, N)
    *MAIN.values(),
    (3, 3000, 1000), (3, 3000, 999),    # chip_smoke.py's ragged K3 shapes
    (4, 512, 2048), (4, 300, 1000), (4, 129, 131),
    (1, 4096, 102400), (16, 4096, 102400), (4, 31, 7), (2, 1, 5),
    (1, 33, 64), (2, 4097, 257), (4, 3073, 32063),
]
TABLE_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _TorchSpy:
    """``torch`` as ``gemm`` sees it, allocating on the CPU what it asks
    for on the card and recording it."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, device=None, **kwargs):
        t = torch.empty(*args, **kwargs)
        self.made.append(t)
        return t


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA request reached the plain version")


@pytest.fixture
def launches(monkeypatch):
    """The recorded launches and the tensors the binding allocated."""
    calls, spy = [], _TorchSpy()
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "torch", spy)
    monkeypatch.setattr(ref, "lm_head_rows_grouped_ref", _no_plain)
    return calls, spy.made


def _table(S, K, N, dtype):
    """A contiguous (S, K, N) stack of ``dtype`` with no data (a meta
    tensor: the main shapes' stacks would take gigabytes), reporting a
    CUDA device."""
    return torch.empty((S, K, N), dtype=dtype, device="meta").as_subclass(_OnCard)


@pytest.mark.parametrize("table_bytes", [4, 2])
@pytest.mark.parametrize("R,K,N", SHAPES)
def test_slices_cover_k_exactly(R, K, N, table_bytes):
    """The warps' slices of K are whole batches but the last, none empty,
    at most one a warp, and cover K once; the strips cover N once, the last
    one ragged where N is not a multiple of the strip."""
    strips, kslice = gemm.row_splits(R, K, N, table_bytes)
    slices = -(-K // kslice)
    assert kslice > 0 and kslice % BATCH == 0
    assert 1 <= slices <= WARPS
    assert (slices - 1) * kslice < K <= slices * kslice
    strip = 512 // table_bytes
    assert (strips - 1) * strip < N <= strips * strip


@pytest.mark.parametrize("table_bytes", [4, 2])
@pytest.mark.parametrize("arch", sorted(MAIN))
def test_main_shapes_fill_an_h100(arch, table_bytes):
    """At both decode shapes the grid gives every one of 132 SMs at least
    3 blocks (of the 4 an SM holds): 504 / 1,004 blocks at phi3's shape on
    bf16 / fp32 tables, 1,600 / 3,200 at deepseek's; every warp streams a
    slice of the same length."""
    R, K, N = MAIN[arch]
    strips, kslice = gemm.row_splits(R, K, N, table_bytes)
    blocks = R * strips
    assert blocks == {("phi3_mini_3p8b", 2): 504, ("phi3_mini_3p8b", 4): 1004,
                      ("deepseek_7b", 2): 1600,
                      ("deepseek_7b", 4): 3200}[arch, table_bytes]
    assert blocks >= 3 * 132
    assert kslice * WARPS == K


@pytest.mark.parametrize("K", [1, 3, 4, 5, 31, 32, 33, 64])
def test_short_k_idles_warps(K):
    """Below 8 batches of 4, each warp takes one batch and the warps past K
    idle; from 33 on, a slice is two batches."""
    _, kslice = gemm.row_splits(1, K, 64, 4)
    assert kslice == (BATCH if K <= WARPS * BATCH else 2 * BATCH)


@pytest.mark.parametrize("t_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,K,N", [*MAIN.values(), (3, 3000, 999),
                                   (4, 129, 131)])
def test_rows_hands_the_kernel_its_operands(launches, R, K, N, h_dtype,
                                            t_dtype):
    """One ``row_gemm`` call with h's, gidx's, the stack's and the output's
    pointers, R, N, K, the slot count, both dtype flags and the rule's
    slice length; nothing allocated but the output.  The wrapper counts one
    launch and never reaches the plain version."""
    calls, made = launches
    S = 6
    before = grouped_row_gemm.launches
    h = torch.zeros(R, K, dtype=h_dtype).as_subclass(_OnCard)
    g = torch.tensor([1, 9, -2, 5][:R] + [0] * max(0, R - 4),
                     dtype=torch.int32).as_subclass(_OnCard)
    tables = _table(S, K, N, t_dtype)
    out = grouped_row_gemm(h, g, tables)
    (args,) = calls
    assert grouped_row_gemm.launches == before + 1
    assert args[:2] == ("grouped_row_gemm", "row_gemm")
    assert args[2] is h
    assert args[3:7] == (h.data_ptr(), g.data_ptr(), tables.data_ptr(),
                         out.data_ptr())
    _, kslice = gemm.row_splits(R, K, N, TABLE_BYTES[t_dtype])
    assert args[7:] == (R, N, K, S, int(h_dtype == torch.bfloat16),
                        int(t_dtype == torch.bfloat16), kslice)
    assert out.shape == (R, N) and out.dtype == h_dtype
    assert made == [out]
