"""The key-row scan of K6's gradient in chunks of time (``csrc/wkv6_rows.cu``
``wkv6_rows_kernel``), modelled on the CPU, its chain order, and what the
wrapper hands the kernel.

The scan runs, from ``M = s0``, ``out_t[i] = M[i, :] . z_t``, then ``M[i, :]
= w_t[i] M[i, :] + x_t[i] y_t``.  The kernel cuts each sequence into chunks
of L tokens.  A block per (sequence, chunk) runs the recurrence from a zero
state over its chunk (the local pass: each token's read-out of the chunk's
own tokens), keeps ``a_{t-1}``, the product of w over the chunk's tokens
before t, and the chunk's product A; then, in chunk order, ``S_start(c +
1)[i, :] = A(c)[i] S_start(c)[i, :] + S_loc(c)[i, :]`` from s0; then each
token's read-out gains ``a_{t-1}[i] (S_start(c)[i, :] . z_t)``.  Nothing is
divided and no factor exceeds 1: strong decay underflows a to 0, as the
token recurrence decays the state.  :func:`rows_chunk_model` does the same in
fp32 torch (all chunks' local passes at once) and is held against the plain
version ``ref.wkv6_rows_ref`` and a float64 token loop.  The card holds the
kernel itself (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: ``TOL`` = 1e-5 of the largest magnitude of the expected array
(the same sums in another order, the decays by ``exp2`` as the kernel takes
them; the state grows to a few hundred times its entries where nothing
decays).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gemm, ref, wkv6_rows  # noqa: E402

LOG2E = 1.4426950408889634
TOL = 1e-5
DECAYS = ("ordinary", "strong", "none")
CHUNKS = (16, 32, 64, 128, 256)      # the lengths ``k6_probe.py rows variants`` builds


def _inputs(seed, BH, T, D, decay):
    """x, y, z ~ N(0, 1); logw = -exp(N) (ordinary), -exp(2 N) (strong) or 0
    (no decay); s0 ~ 0.1 N."""
    rng = np.random.default_rng(seed)
    x, y, z, n = (rng.standard_normal((BH, T, D)).astype(np.float32)
                  for _ in range(4))
    logw = {"ordinary": -np.exp(n), "strong": -np.exp(2 * n),
            "none": np.zeros_like(n)}[decay].astype(np.float32)
    s0 = (rng.standard_normal((BH, D, D)) * 0.1).astype(np.float32)
    return x, y, z, logw, s0


def rows_chunk_model(x, y, z, logw, s0, L):
    """The chunked key-row scan in fp32 torch: out (BH, T, D).  The last
    chunk is padded as the kernel pads its last tile (w = 1, x = y = z = 0);
    its padded outputs are dropped."""
    BH, T, D = x.shape
    nc = -(-T // L)
    pad = nc * L - T
    grow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, pad))  # noqa: E731
    w = torch.exp2(grow(logw) * LOG2E)
    w[:, T:] = 1.0
    x, y, z = (grow(a).reshape(BH, nc, L, D) for a in (x, y, z))
    w = w.reshape(BH, nc, L, D)
    # The local pass of every chunk at once, from a zero state.
    M = torch.zeros(BH, nc, D, D)
    a = torch.ones(BH, nc, D)
    local, a_prev = [], []
    for t in range(L):
        local.append(torch.einsum("bcij,bcj->bci", M, z[:, :, t]))
        a_prev.append(a)
        M = w[:, :, t, :, None] * M + x[:, :, t, :, None] * y[:, :, t, None, :]
        a = a * w[:, :, t]
    # The chain, in chunk order; the last chunk publishes nothing.
    starts = [s0]
    for c in range(nc - 1):
        starts.append(a[:, c, :, None] * starts[-1] + M[:, c])
    # The correction.
    out = torch.stack(local, 2) + torch.stack(a_prev, 2) * torch.einsum(
        "bcij,bctj->bcti", torch.stack(starts, 1), z)
    return out.reshape(BH, nc * L, D)[:, :T]


def _token_loop64(x, y, z, logw, s0):
    """The key-row recurrence token by token in float64 numpy."""
    x, y, z, logw, m = (np.asarray(a, np.float64) for a in (x, y, z, logw, s0))
    w = np.exp(logw)
    out = np.empty_like(x)
    for t in range(x.shape[1]):
        out[:, t] = np.einsum("bij,bj->bi", m, z[:, t])
        m = w[:, t, :, None] * m + x[:, t, :, None] * y[:, t, None, :]
    return out


def _within(got, want, share=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, lim = float(np.abs(got - want).max()), share * float(np.abs(want).max())
    assert err <= lim, f"max|got - want| {err} > {lim}"


# (T, L): below, at and across the chunk, ragged ends and one token.
CASES = [(1, 64), (20, 64), (63, 64), (64, 64), (65, 64), (200, 64),
         (100, 32), (300, 128)]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,L", CASES)
@pytest.mark.parametrize("D", [16, 64])
def test_model_matches_plain_and_float64(D, T, L, decay):
    """The model against ``ref.wkv6_rows_ref`` (the CPU wrapper's plain
    version) and the float64 token loop, nonzero s0."""
    ops = _inputs(T * D + L + DECAYS.index(decay), 2, T, D, decay)
    got = rows_chunk_model(*map(torch.from_numpy, ops), L)
    assert bool(torch.isfinite(got).all())
    plain = wkv6_rows(*map(torch.from_numpy, ops))
    _within(got, plain)
    _within(got, _token_loop64(*ops))


def test_strong_decay_underflows_a_to_zero():
    """Under strong decay the chunk products underflow to exactly 0 (no
    factor exceeds 1, nothing is divided); the model stays finite and
    holds the float64 recurrence."""
    ops = _inputs(11, 2, 256, 64, "strong")
    w = np.exp2(ops[3].astype(np.float32) * np.float32(LOG2E))
    assert (w.reshape(2, 4, 64, 64).prod(2, dtype=np.float32) == 0).any()
    got = rows_chunk_model(*map(torch.from_numpy, ops), 64)
    assert bool(torch.isfinite(got).all())
    _within(got, _token_loop64(*ops))


@pytest.mark.parametrize("L", CHUNKS)
def test_chunk_length_does_not_change_the_result(L):
    """Every L the kernel can be built with gives the plain version's
    result up to rounding, T = 300 a multiple of none."""
    ops = _inputs(5, 3, 300, 16, "ordinary")
    _within(rows_chunk_model(*map(torch.from_numpy, ops), L),
            ref.wkv6_rows_ref(*map(torch.from_numpy, ops)))


@pytest.mark.parametrize("BH,nc,resident", [(1, 7, 1), (80, 64, 396), (40, 2, 3),
                                            (3, 1, 1), (80, 1024, 396)])
def test_ticket_order_waits_only_on_earlier_tickets(BH, nc, resident):
    """The kernel maps ticket n to chunk n // BH of sequence n % BH: every
    chunk past the first waits on chunk c - 1 of its sequence, whose ticket
    n - BH was taken first; the tickets cover every (sequence, chunk) once.
    With blocks starting in ticket order on a card that holds ``resident``
    at once, each waiting only on its predecessor's flag, every block
    finishes (the grid may be far larger than the card)."""
    seen = set()
    for n in range(BH * nc):
        c, bh = divmod(n, BH)
        seen.add((bh, c))
        if c:
            assert 0 <= (c - 1) * BH + bh < n
    assert seen == {(b, c) for b in range(BH) for c in range(nc)}
    published, running, taken = set(), [], 0
    while len(published) < BH * nc:
        while len(running) < resident and taken < BH * nc:
            running.append(taken)
            taken += 1
        done = [n for n in running if n < BH or n - BH in published]
        assert done, f"no running block can finish: {running}"
        published.update(done)
        running = [n for n in running if n not in published]


# -- what the wrapper hands the kernel -------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes its
    kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA request reached the plain version")


def _library_words(BH, T):
    """Stands in for the library's ``wkv6_rows_sync_words``: a count that
    no Python rule of the flags' layout could give by accident."""
    return 1000 * BH + 10 * T + 3


def _library(chunk, asked=None):
    """Stands in for ``gemm._entry`` on the library's two shape queries:
    ``wkv6_rows_chunk`` gives ``chunk``, ``wkv6_rows_sync_words``
    :func:`_library_words` (its arguments appended to ``asked``)."""
    def words(*a):
        if asked is not None:
            asked.append(a)
        return _library_words(*a)

    fns = {"wkv6_rows_chunk": lambda: chunk, "wkv6_rows_sync_words": words}
    return lambda symbol: (fns[symbol], None)


def _card_ops(BH, T, D):
    return (*(torch.zeros(BH, T, D).as_subclass(_OnCard) for _ in range(4)),
            torch.zeros(BH, D, D).as_subclass(_OnCard))


@pytest.mark.parametrize("BH,T,D", [(8, 4096, 64), (4, 100, 16), (2, 1, 64),
                                    (3, 65, 16)])
def test_wrapper_hands_the_kernel_its_operands(monkeypatch, BH, T, D):
    """One ``wkv6_rows`` launch with the operands' and output's pointers,
    the start-state and sync workspaces (``test_rows_workspaces``), BH, T
    and D (the chunk length is the library's); counted once; no plain
    version."""
    calls = []
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "_entry", _library(64))
    monkeypatch.setattr(ref, "wkv6_rows_ref", _no_plain)
    ops = _card_ops(BH, T, D)
    before = wkv6_rows.launches
    out = wkv6_rows(*ops)
    (args,) = calls
    assert wkv6_rows.launches == before + 1
    assert args[:2] == ("wkv6_rows", "wkv6_rows")
    assert args[3:8] == tuple(a.data_ptr() for a in ops)
    assert args[8] == out.data_ptr()
    assert args[11:] == (BH, T, D)
    assert out.shape == (BH, T, D) and out.dtype == torch.float32


@pytest.mark.parametrize("BH,T,D,L", [(5, 300, 64, 64), (2, 20, 16, 32),
                                      (3, 256, 16, 128), (8, 4096, 64, 48)])
def test_rows_workspaces(monkeypatch, BH, T, D, L):
    """The start-state workspace holds (nc - 1) * BH * D * D floats (at
    least one), nc the chunks of the library's ``wkv6_rows_chunk`` L; the
    sync buffer, zeroed int32s, as many as the library's
    ``wkv6_rows_sync_words`` gives for (BH, T), asked once: the chunk
    length and the flags' layout have one copy, in the kernel's source
    (``tests/test_torch_cuda.py`` checks them there)."""
    made, asked = {}, []

    def record(name, symbol, a, *args):
        made["states"], made["sync"] = args[6], args[7]

    monkeypatch.setattr(gemm, "_call", record)
    monkeypatch.setattr(gemm, "_entry", _library(L, asked))
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
    gemm.key_rows("wkv6_rows", *_card_ops(BH, T, D))
    nc = -(-T // L)
    # (A subclass's method call passes through the spy twice.)
    (states,) = {t.data_ptr(): t for kind, t in tensors
                 if kind == "empty" and t.data_ptr() == made["states"]}.values()
    (sync,) = {t.data_ptr(): t for kind, t in tensors
               if kind == "zeros" and t.data_ptr() == made["sync"]}.values()
    assert states.dtype == torch.float32
    assert states.numel() == max(nc - 1, 1) * BH * D * D
    assert sync.dtype == torch.int32 and sync.numel() == _library_words(BH, T)
    assert not bool(sync.any()) and asked == [(BH, T)]
