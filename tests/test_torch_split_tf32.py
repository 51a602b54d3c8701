"""The split-TF32 arithmetic of ``csrc/aug_gemm.cu`` (K2, and K5 in fp32),
modelled on the CPU, and what the wrappers hand that kernel.

The kernel splits each fp32 operand x into hi = tf32_rna(x) and lo =
tf32_rna(x - hi) (``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from
zero).  Per k-step of 8 it issues three TF32 MMAs into one stage
accumulator, in its order hi(a) lo(b), lo(a) hi(b), hi(a) hi(b); each stage
of 32 k starts a fresh accumulator, which an fp32 add (round to nearest)
puts into the running total.  The model does the same in torch, with the
tensor cores' rounding modelled as each MMA's sum (the accumulator plus its
8 products of TF32 values, all exact) truncated toward zero to fp32.  It
holds the split form within 1e-5 of max|fp64 product| (the delivery
reference's own bound) at K up to 3072; one TF32 pass misses that bound,
and so does the split form summed into one truncating accumulator over all
of K at K = 3072: the two reasons the kernel splits the operands and sums
per stage.  The card holds the kernel itself at the same bound
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The wrapper tests run ``aug_gemm`` and ``grouped_aug_gemm`` on CPU tensors
that report a CUDA device, with the launch recorded instead of made.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import aug_gemm, gemm, grouped_aug_gemm, ref  # noqa: E402

FP64_REL_TOL = 1e-5
KSTEP = 8                        # k per TF32 MMA (wgmma ...k8)
STAGE = 32                       # k per stage accumulator


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32: add
    half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rz32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int,
                 stage: int | None = STAGE) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` as the kernel sums it: per k-step of 8, three
    TF32 MMAs over the split operands (``passes=3``) or one over
    ``tf32_rna`` of each (``passes=1``), each truncating its sum toward
    zero; a fresh accumulator every ``stage`` k, added to the total in fp32
    rounded to nearest.  ``stage=None``: one accumulator over all of K."""
    pad = -a.shape[1] % KSTEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    terms = [(ah, bl), (al, bh), (ah, bh)] if passes == 3 else [(ah, bh)]
    K = a.shape[1]
    total = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    part = torch.zeros_like(total)
    for k in range(0, K, KSTEP):
        for x, y in terms:
            part = rz32(part.double() + x[:, k:k + KSTEP].double() @ y[k:k + KSTEP].double())
        if stage is not None and ((k + KSTEP) % stage == 0 or k + KSTEP == K):
            total = (total.double() + part.double()).float()
            part = torch.zeros_like(part)
    return part if stage is None else total


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def _rel_err(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    want = a.double() @ b.double()
    return float((got.double() - want).abs().max() / want.abs().max())


SHAPES = [(16, 8, 16), (33, 300, 17), (8, 1000, 64), (64, 3072, 128)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_split_form_holds_fp64_bound(M, K, N):
    """Three TF32 passes over split operands: within 1e-5 of max|fp64|."""
    a, b = _operands(M * K + N, M, K, N)
    assert _rel_err(split_matmul(a, b, 3), a, b) <= FP64_REL_TOL


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_one_tf32_pass_misses_fp64_bound(M, K, N):
    """One TF32 pass (what the tensor cores give fp32 operands unsplit)
    falls outside the bound at every shape: it is not used."""
    a, b = _operands(M * K + N, M, K, N)
    assert _rel_err(split_matmul(a, b, 1), a, b) > FP64_REL_TOL


@pytest.mark.parametrize("M,K,N", [(64, 3072, 128), (16, 3072, 256)])
def test_one_truncating_accumulator_misses_fp64_bound(M, K, N):
    """The split form summed into one accumulator over all of K: 1,152
    truncations toward zero at K = 3072 add up past the bound (the card
    read 2.4e-5 of max|fp64| for that design).  The kernel sums per stage
    of 32 k instead."""
    a, b = _operands(M * K + N, M, K, N)
    assert _rel_err(split_matmul(a, b, 3, stage=None), a, b) > FP64_REL_TOL


def split_k_matmul(a: torch.Tensor, b: torch.Tensor, splits: int,
                   stage: int | None = STAGE) -> torch.Tensor:
    """K4's fp32 route (``aug_sgemm_split``): K in ``splits`` slices of
    ``ceil(ceil(K / 32) / splits)`` stages of 32 k, the last taking the
    rest; each slice summed as :func:`split_matmul` sums (a fresh
    accumulator a stage, or one truncating accumulator over the slice with
    ``stage=None``) into an fp32 partial, and the partials added in slice
    order in fp32, rounded to nearest (``split_reduce_kernel``)."""
    K = a.shape[1]
    per = -(-(-(-K // STAGE)) // splits) * STAGE
    assert (splits - 1) * per < K, "a slice would be empty"
    total = None
    for j in range(splits):
        ks = slice(j * per, min(K, (j + 1) * per))
        part = split_matmul(a[:, ks], b[ks], 3, stage)
        total = part if total is None else (total.double() + part.double()).float()
    return total


@pytest.mark.parametrize("M,K,N,splits", [(16, 96, 16, 2), (33, 300, 17, 3),
                                          (8, 1000, 64, 5), (64, 3072, 128, 5),
                                          (20, 640, 40, 10)])
def test_split_k_holds_fp64_bound(M, K, N, splits):
    """K4's split form: the split-TF32 sum in slices of K, added in slice
    order, within 1e-5 of max|fp64| (the bound ``chip_smoke.py`` holds K4
    to on the card), at every split the kernel takes here."""
    a, b = _operands(M * K + N + splits, M, K, N)
    assert _rel_err(split_k_matmul(a, b, splits), a, b) <= FP64_REL_TOL


def test_split_k_with_one_truncating_accumulator_misses_fp64_bound():
    """Slicing K does not spare the per-stage accumulators: two slices of
    1,536 k, each summed into one truncating accumulator, keep the bias of
    their 1,152 truncations toward zero in all, and miss the bound."""
    M, K, N = 64, 3072, 128
    a, b = _operands(M * K + N, M, K, N)
    assert _rel_err(split_k_matmul(a, b, 2, stage=None), a, b) > FP64_REL_TOL


def test_tf32_rounding_and_split():
    """tf32_rna rounds to 10 mantissa bits, ties away from zero, on both
    signs; hi + lo recovers x to within 2^-21 of |x|."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one,
                         one + 2 ** -10, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32)) * 1e3
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert bool(((hi.double() + lo.double() - r.double()).abs()
                 <= 2.0 ** -21 * r.double().abs()).all())


# -- the wrappers' kernel branch, with the launch recorded -----------------

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


def _library_floats(G, M, K):
    """Stands in for the library's ``aug_workspace_floats``: a count that no
    Python rule of the layout could give by accident."""
    return 1000 * G + 10 * M + K + 7


def _library_entry(asked):
    """``gemm._entry`` for the workspace query only, recording its
    arguments."""
    def entry(symbol):
        assert symbol == "aug_workspace_floats"
        return (lambda *args: asked.append(args) or _library_floats(*args)), None
    return entry


@pytest.fixture
def launches(monkeypatch):
    """The recorded launches and the tensors the binding allocated."""
    calls, spy = [], _TorchSpy()
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "_entry", _library_entry([]))
    monkeypatch.setattr(gemm, "torch", spy)
    for plain in ("aug_gemm_ref", "aug_gemm_batched_ref", "aug_gemm_grouped_ref"):
        monkeypatch.setattr(ref, plain, _no_plain)
    return calls, spy.made


def _workspace(made, out, ws_ptr, G, M, K, dtype):
    """fp32: one fp32 workspace of the floats the library asked for (the
    split T), whose pointer the kernel got; bf16: none, a null pointer."""
    ws = [t for t in made if t.data_ptr() != out.data_ptr()]
    if dtype == torch.bfloat16:
        assert ws == [] and ws_ptr is None
        return
    (w,) = ws
    assert w.dtype == torch.float32 and w.numel() == _library_floats(G, M, K)
    assert ws_ptr == w.data_ptr()


def _on_card(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(_OnCard)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,B,K,N", [(None, 256, 3072, 1024), (None, 7, 33, 9),
                                     (3, 5, 300, 1000)])
def test_aug_gemm_hands_the_kernel_its_operands(launches, dtype, G, B, K, N):
    """K5: one ``aug_gemm_typed`` call with t's, c_ac's, the output's and
    the workspace's pointers, G (1 for 2-D operands), M = rows, N, K and the
    bf16 flag."""
    calls, made = launches
    lead = () if G is None else (G,)
    t = _on_card(torch.zeros(*lead, B, K, dtype=dtype))
    c = _on_card(torch.zeros(*lead, K, N, dtype=dtype))
    before = aug_gemm.launches
    out = aug_gemm(t, c)
    (args,) = calls
    assert aug_gemm.launches == before + 1
    assert args[:2] == ("aug_gemm", "aug_gemm_typed")
    assert args[3:6] == (t.data_ptr(), c.data_ptr(), out.data_ptr())
    assert args[7:] == (G or 1, B, N, K, int(dtype == torch.bfloat16))
    _workspace(made, out, args[6], G or 1, B, K, dtype)
    assert out.shape == (*lead, B, N) and out.dtype == dtype


@pytest.mark.parametrize("S,gidx", [(6, [4, 0, 5, 2]), (6, [1, 9, -2, 5]),
                                    (4, [0, 1, 2, 3]), (1, [0, 0])])
def test_grouped_aug_gemm_hands_the_kernel_its_operands(launches, S, gidx):
    """K2: one ``aug_sgemm_grouped`` call with t's, gidx's, the stack's, the
    output's and the workspace's pointers, G, M, N, K and the slot count S.
    The gidx vector goes to the kernel as it is (the kernel clamps each
    entry)."""
    calls, made = launches
    G, B, K, N = len(gidx), 64, 3072, 256
    t = _on_card(torch.zeros(G, B, K))
    g = _on_card(torch.tensor(gidx, dtype=torch.int32))
    c = _on_card(torch.zeros(S, K, N))
    before = grouped_aug_gemm.launches
    out = grouped_aug_gemm(t, g, c)
    (args,) = calls
    assert grouped_aug_gemm.launches == before + 1
    assert args[:2] == ("grouped_aug_gemm", "aug_sgemm_grouped")
    assert args[3:7] == (t.data_ptr(), g.data_ptr(), c.data_ptr(), out.data_ptr())
    assert args[8:] == (G, B, N, K, S)
    _workspace(made, out, args[7], G, B, K, torch.float32)
    assert out.shape == (G, B, N) and out.dtype == torch.float32


def test_grouped_aug_gemm_is_fp32_only_on_the_card(launches):
    """K2's entry point is fp32: bf16 operands raise before any launch."""
    t = _on_card(torch.zeros(2, 4, 8, dtype=torch.bfloat16))
    g = _on_card(torch.zeros(2, dtype=torch.int32))
    c = _on_card(torch.zeros(3, 8, 16, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="one dtype"):
        grouped_aug_gemm(t, g, c)
    assert launches == ([], [])


@pytest.mark.parametrize("G,M,K", [(1, 256, 3072), (4, 64, 3072), (1, 130, 257),
                                   (3, 5, 300)])
def test_workspace_size_is_the_librarys(monkeypatch, G, M, K):
    """The workspace's size is the count ``csrc/aug_gemm.cu`` exports for
    the shape, asked once with G, M, K: the layout's rule has one copy, in
    the kernel's source (``tests/test_torch_cuda.py`` checks it there)."""
    asked = []
    monkeypatch.setattr(gemm, "_entry", _library_entry(asked))
    assert gemm.aug_workspace_floats(G, M, K) == _library_floats(G, M, K)
    assert asked == [(G, M, K)]
