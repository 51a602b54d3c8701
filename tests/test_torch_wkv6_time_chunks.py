"""K6's time-chunked form (``csrc/wkv6.cu`` ``wkv6_chunks_kernel``), modelled
on the CPU, its form rule, and what the wrapper hands the kernel.

The form cuts each sequence into chunks of L tokens.  A block per (sequence,
chunk) runs the state-column recurrence from a zero state over its chunk
(the local pass: each token's read-out of the chunk's own tokens, plus its
bonus), keeps ``r_t A_{t-1}`` with ``A_{t-1}`` the product of w over the
chunk's tokens before t, and the chunk's product A; then, in chunk order,
``S_start(c + 1) = diag(A(c)) S_start(c) + S_loc(c)`` from s0 (the last is
s_final); then each token's read-out gains ``(r_t A_{t-1}) . S_start(c)``.
Nothing is divided and no factor exceeds 1: strong decay underflows A to 0,
as the token recurrence would decay the state.  :func:`time_chunk_model`
does the same in fp32 torch (all chunks' local passes at once) and is held
against the token recurrence (``ref.wkv6_ref``), the port's plain chunked
scan (``ref.wkv6_chunked_ref``) and the JAX package's Pallas kernel in
interpret mode.  The card holds the kernel itself
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, as shares of the largest magnitude of the expected array:
``REC_TOL`` 1e-5 against the token recurrence (the same sums in another
order), ``CHUNK_TOL`` 1e-4 against the chunked forms (decays from
cumulative sums), or the chunked form's own distance from the recurrence
plus ``REC_TOL`` where that is larger (strong decay), as in
``tests/test_torch_wkv6_columns.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6_chunked as pallas_wkv6  # noqa: E402
from repro_torch.kernels import gemm, ref, wkv6_chunked  # noqa: E402

LOG2E = 1.4426950408889634
REC_TOL = 1e-5
CHUNK_TOL = 1e-4
DECAYS = ("ordinary", "strong", "none")


def _inputs(seed, BH, T, D, decay):
    """r, k, v ~ N(0, 1); logw = -exp(N) (ordinary), -exp(2 N) (strong) or
    0 (no decay); u ~ N; s0 ~ 0.1 N."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, D)).astype(np.float32) for _ in range(3))
    z = rng.standard_normal((BH, T, D)).astype(np.float32)
    logw = {"ordinary": -np.exp(z), "strong": -np.exp(2 * z),
            "none": np.zeros_like(z)}[decay].astype(np.float32)
    u = rng.standard_normal((BH, D)).astype(np.float32)
    s0 = (rng.standard_normal((BH, D, D)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def time_chunk_model(r, k, v, logw, u, s0, L):
    """The time-chunked form in fp32 torch: (out (BH, T, D), s_final).  The
    last chunk is padded as the kernel pads its last tile (w = 1, k = v = 0,
    r A = 0); its padded outputs are dropped."""
    BH, T, D = r.shape
    nc = -(-T // L)
    pad = nc * L - T
    grow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, pad))  # noqa: E731
    w = torch.exp2(grow(logw) * LOG2E)
    w[:, T:] = 1.0
    bonus = (r * u[:, None, :] * k).sum(-1, keepdim=True)
    r, k, v, bonus = (grow(a).reshape(BH, nc, L, -1) for a in (r, k, v, bonus))
    w = w.reshape(BH, nc, L, D)
    # The local pass of every chunk at once, from a zero state.
    S = torch.zeros(BH, nc, D, D)
    A = torch.ones(BH, nc, D)
    local, rp = [], []
    for t in range(L):
        local.append(torch.einsum("bcd,bcdj->bcj", r[:, :, t], S)
                     + bonus[:, :, t] * v[:, :, t])
        rp.append(r[:, :, t] * A)
        S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None, :]
        A = A * w[:, :, t]
    # The state chain, in chunk order.
    starts = [s0]
    for c in range(nc):
        starts.append(A[:, c, :, None] * starts[-1] + S[:, c])
    # The correction.
    out = torch.stack(local, 2) + torch.einsum(
        "bctd,bcdj->bctj", torch.stack(rp, 2), torch.stack(starts[:-1], 1))
    return out.reshape(BH, nc * L, D)[:, :T], starts[-1]


def _dist(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _within(got, want, share):
    err, scale = _dist(got, want)
    assert err <= share * scale, f"max|got - want| {err} > {share * scale}"


def _within_chunked(got, chunked, rec):
    err, scale = _dist(got, chunked)
    lim = max(CHUNK_TOL * scale, _dist(chunked, rec)[0] + REC_TOL * scale)
    assert err <= lim, f"max|got - chunked| {err} > {lim}"


def _recurrence(ops):
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in ops)
    o, s = ref.wkv6_ref(r[None], k[None], v[None], logw[None], u, s0[None])
    return o[0], s[0]


# (T, L, chunk): several L, T not a multiple of L, T < L, one token; the
# reference scan's chunk divides T.
CASES = [(1, 32, 128), (20, 32, 20), (100, 32, 20), (128, 64, 32),
         (300, 128, 100), (384, 128, 128), (256, 256, 128), (200, 64, 40)]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,L,chunk", CASES)
@pytest.mark.parametrize("D", [16, 64])
def test_model_matches_recurrence_and_chunked_ref(D, T, L, chunk, decay):
    """The model against the token recurrence and the port's plain chunked
    scan, out and final state, nonzero s0."""
    ops = _inputs(T * D + L + DECAYS.index(decay), 2, T, D, decay)
    got_o, got_s = time_chunk_model(*map(torch.from_numpy, ops), L)
    assert bool(torch.isfinite(got_o).all()) and bool(torch.isfinite(got_s).all())
    rec_o, rec_s = _recurrence(ops)
    _within(got_o, rec_o, REC_TOL)
    _within(got_s, rec_s, REC_TOL)
    ch_o, ch_s = ref.wkv6_chunked_ref(*map(torch.from_numpy, ops), chunk=chunk)
    _within_chunked(got_o, ch_o, rec_o)
    _within_chunked(got_s, ch_s, rec_s)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,L,chunk", [(100, 32, 20), (384, 128, 128), (20, 32, 20)])
@pytest.mark.parametrize("D", [16, 64])
def test_model_matches_pallas(D, T, L, chunk, decay):
    """The model against the JAX package's ``wkv6_chunked`` (the Pallas
    kernel in interpret mode) and its token recurrence ``ref.wkv6_ref``."""
    ops = _inputs(7 * T + D + DECAYS.index(decay), 2, T, D, decay)
    pl_o, pl_s = pallas_wkv6(*map(jnp.asarray, ops), chunk=chunk, interpret=True)
    r, k, v, logw, u, s0 = ops
    rec_o, rec_s = jref.wkv6_ref(*(jnp.asarray(a[None]) for a in (r, k, v, logw)),
                                 jnp.asarray(u), jnp.asarray(s0[None]))
    rec_o, rec_s = np.asarray(rec_o)[0], np.asarray(rec_s)[0]
    got_o, got_s = time_chunk_model(*map(torch.from_numpy, ops), L)
    _within(got_o, rec_o, REC_TOL)
    _within(got_s, rec_s, REC_TOL)
    _within_chunked(got_o, pl_o, rec_o)
    _within_chunked(got_s, pl_s, rec_s)


def test_strong_decay_underflows_a_to_zero():
    """Under strong decay the chunk products A underflow to exactly 0 (no
    factor exceeds 1, nothing is divided), and the model still holds the
    recurrence: an underflowed A carries nothing the recurrence keeps."""
    ops = _inputs(11, 2, 256, 64, "strong")
    w = np.exp2(ops[3].astype(np.float64) * LOG2E)
    assert (w.reshape(2, 2, 128, 64).prod(2) == 0).any()
    got_o, got_s = time_chunk_model(*map(torch.from_numpy, ops), 128)
    rec_o, rec_s = _recurrence(ops)
    _within(got_o, rec_o, REC_TOL)
    _within(got_s, rec_s, REC_TOL)


@pytest.mark.parametrize("L", gemm.SCAN_CHUNKS)
def test_chunk_length_does_not_change_the_result(L):
    """Every L the kernel takes gives the recurrence's result up to
    rounding, T = 300 not a multiple of any."""
    ops = _inputs(5, 3, 300, 16, "ordinary")
    rec_o, rec_s = _recurrence(ops)
    got_o, got_s = time_chunk_model(*map(torch.from_numpy, ops), L)
    _within(got_o, rec_o, REC_TOL)
    _within(got_s, rec_s, REC_TOL)


@pytest.mark.parametrize("BH,nc", [(1, 7), (80, 32), (40, 2), (3, 1)])
def test_ticket_order_waits_only_on_earlier_tickets(BH, nc):
    """The kernel maps ticket n to chunk n // BH of sequence n % BH: every
    chunk past the first waits on chunk c - 1 of its sequence, whose ticket
    is n - BH, taken before its own, so the block it waits on is running
    or done; the tickets cover every (sequence, chunk) once."""
    seen = set()
    for n in range(BH * nc):
        c, bh = divmod(n, BH)
        seen.add((bh, c))
        if c:
            pred = (c - 1) * BH + bh
            assert 0 <= pred < n
    assert seen == {(b, c) for b in range(BH) for c in range(nc)}


# -- the form rule ----------------------------------------------------------

@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("BH,T", [(1, 1), (40, 384), (40, 1024), (160, 128),
                                  (40, 32), (80, 4096), (2, 100000)])
@pytest.mark.parametrize("D", [16, 64])
def test_scan_form_is_valid_and_pure(D, BH, T, sms):
    """Every shape gets a form the kernel takes: a width the columns kernel
    takes, or a chunk length of ``SCAN_CHUNKS``; the rule is a pure function
    (memoised, the same answer again)."""
    first = gemm.scan_form(BH, T, D, sms)
    form, size = first
    assert form in ("columns", "chunks")
    if form == "columns":
        assert size == gemm.scan_width(BH, D, sms) and size in gemm.scan_widths(D)
    else:
        assert size in gemm.SCAN_CHUNKS
    gemm.scan_form.cache_clear()
    assert gemm.scan_form(BH, T, D, sms) == first


def test_scan_form_at_the_main_shapes():
    """The prefill's (40, 384) keeps the columns form (C = 24, one block an
    SM); rwkv_train's (80, 4096) takes the chunked form with enough
    (sequence, chunk) blocks to fill 132 SMs many times over, each owning
    all 64 columns."""
    assert gemm.scan_form(40, 384, 64, 132) == ("columns", 24)
    form, L = gemm.scan_form(80, 4096, 64, 132)
    assert form == "chunks"
    assert 80 * -(-4096 // L) >= 8 * 132


# -- what the wrapper hands the kernel -------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes its
    kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA request reached the plain version")


def _library_words(BH, T, L):
    """Stands in for the library's ``wkv6_chunk_sync_words``: a count that
    no Python rule of the flags' layout could give by accident."""
    return 1000 * BH + 10 * T + L + 3


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "sm_count", lambda device: 132)
    monkeypatch.setattr(gemm, "_entry", lambda symbol: (
        (lambda *a: _library_words(*a)), None))
    monkeypatch.setattr(ref, "wkv6_chunked_ref", _no_plain)
    return calls


def _card_ops(BH, T, D):
    seq = [torch.zeros(BH, T, D).as_subclass(_OnCard) for _ in range(4)]
    return (*seq, torch.zeros(BH, D).as_subclass(_OnCard),
            torch.zeros(BH, D, D).as_subclass(_OnCard))


@pytest.mark.parametrize("BH,T,D,L", [(80, 4096, 64, None), (4, 100, 16, 32),
                                      (2, 20, 64, 64), (3, 256, 16, 128)])
def test_wrapper_hands_the_chunk_kernel_its_operands(launches, monkeypatch,
                                                     BH, T, D, L):
    """Where the rule takes the chunked form (rwkv_train's shape, or a form
    forced through the rule): one ``wkv6_time_chunks`` launch with the
    operands' and outputs' pointers, the start-state and sync workspaces
    (``test_chunk_workspaces``), BH, T, D and L; counted once."""
    if L is not None:
        monkeypatch.setattr(gemm, "scan_form", lambda *a: ("chunks", L))
    else:
        L = gemm.scan_form(BH, T, D, 132)[1]
    ops = _card_ops(BH, T, D)
    before = wkv6_chunked.launches
    out, s_fin = wkv6_chunked(*ops, chunk=min(T, 128) if T % min(T, 128) == 0
                              else T)
    (args,) = launches
    assert wkv6_chunked.launches == before + 1
    assert args[:2] == ("wkv6_chunked", "wkv6_time_chunks")
    assert args[3:9] == tuple(a.data_ptr() for a in ops)
    assert args[9:11] == (out.data_ptr(), s_fin.data_ptr())
    assert args[13:] == (BH, T, D, L)
    assert out.shape == (BH, T, D) and s_fin.shape == (BH, D, D)


@pytest.mark.parametrize("BH,T,D,L", [(5, 300, 64, 128), (2, 20, 16, 32),
                                      (3, 256, 16, 128)])
def test_chunk_workspaces(monkeypatch, BH, T, D, L):
    """The start-state workspace holds (nc - 1) * BH * D * D floats (at
    least one); the sync buffer, zeroed int32s, as many as the library's
    ``wkv6_chunk_sync_words`` gives for (BH, T, L), asked once: the flags'
    layout has one copy, in the kernel's source (``tests/test_torch_cuda.py``
    checks it there)."""
    made, asked = {}, []

    def record(name, symbol, a, *args):
        made["states"], made["sync"] = args[8], args[9]

    def entry(symbol):
        assert symbol == "wkv6_chunk_sync_words"
        return (lambda *a: asked.append(a) or _library_words(*a)), None

    monkeypatch.setattr(gemm, "_call", record)
    monkeypatch.setattr(gemm, "_entry", entry)
    spy_zeros, spy_empty = torch.Tensor.new_zeros, torch.Tensor.new_empty
    tensors = []

    def new_zeros(self, *a, **k):
        t = spy_zeros(self, *a, **k)
        tensors.append(("zeros", t))
        return t

    def new_empty(self, *a, **k):
        t = spy_empty(self, *a, **k)
        tensors.append(("empty", t))
        return t

    monkeypatch.setattr(torch.Tensor, "new_zeros", new_zeros)
    monkeypatch.setattr(torch.Tensor, "new_empty", new_empty)
    ops = _card_ops(BH, T, D)
    gemm.scan("wkv6_chunked", *ops, tokens=L)
    nc = -(-T // L)
    # (A subclass's method call passes through the spy twice.)
    (states,) = {t.data_ptr(): t for kind, t in tensors
                 if kind == "empty" and t.data_ptr() == made["states"]}.values()
    (sync,) = {t.data_ptr(): t for kind, t in tensors
               if kind == "zeros" and t.data_ptr() == made["sync"]}.values()
    assert states.dtype == torch.float32
    assert states.numel() == max(nc - 1, 1) * BH * D * D
    assert sync.dtype == torch.int32 and sync.numel() == _library_words(BH, T, L)
    assert not bool(sync.any()) and asked == [(BH, T, L)]
