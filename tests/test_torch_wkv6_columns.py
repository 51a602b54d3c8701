"""K6's state-column recurrence (``csrc/wkv6.cu``), modelled on the CPU, and
what its wrapper hands the kernel.

The kernel runs the RWKV-6 token recurrence column by column of the state:
each column's D rows are split over G threads (rows ``4 (q G + g) + e`` for
row group g), each summing its rows' read-out ``r_t[d] S[d, j]`` in row
order; the G partial sums are added by a butterfly over the column's lanes
(the pairs g, g ^ G/2 first, then g ^ G/4, ...), then ``bonus_t v_t[j]``
(bonus = sum_d r_d u_d k_d); the state takes ``S = w S + k v[j]`` with
``w = e^{logw}``.  Tokens arrive in tiles of 32; the last tile's missing rows
are set to w = 1, k = v = 0.  :func:`column_model` does the same in torch
(fp32, each fused multiply-add as a product and a sum), and is held against
the Pallas kernel in interpret mode and the reference's token recurrence.
The butterfly is simulated lane by lane against the model's halving sum.
The card holds the kernel itself (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances, as shares of the largest magnitude of the expected array:
``REC_TOL`` 1e-5 against the token recurrence (the same recurrence, sums in
another order; the model reads 4e-8 to 4e-7), ``CHUNK_TOL`` 1e-4 against the
Pallas kernel's chunked form (decays from cumulative sums;
``tests/test_torch_rwkv.py``'s ``SCAN_TOL``).  Under strong decay the
chunked form is itself that far from the recurrence (1.0e-4 of max|out| at
T = 384, D = 16: its cumulative sums of logw reach thousands, and each
pairwise exponent keeps their 2^-24), so against it the bound is the larger
of ``CHUNK_TOL`` and its own distance from the recurrence plus ``REC_TOL``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6_chunked as pallas_wkv6  # noqa: E402
from repro_torch.kernels import gemm, ref, wkv6_chunked  # noqa: E402

TILE = 32                       # tokens per ring slot in wkv6.cu
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


def _row_groups(D: int, G: int) -> torch.Tensor:
    """(G, D / G): row group g's rows in the order its thread sums them."""
    return torch.tensor([[4 * (q * G + g) + e for q in range(D // G // 4)
                          for e in range(4)] for g in range(G)])


def _halving_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 (G partials) as the butterfly adds them: index i with
    i + G/2 first, then with i + G/4, ..."""
    while p.shape[1] > 1:
        h = p.shape[1] // 2
        p = p[:, :h] + p[:, h:]
    return p[:, 0]


def column_model(r, k, v, logw, u, s0, G, tile=TILE):
    """The kernel's arithmetic in fp32 torch: (out (BH, T, D), s_final).
    Tokens run in tiles of ``tile``, the last one padded as the kernel pads
    it."""
    BH, T, D = r.shape
    pad = -T % tile
    grow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, pad))  # noqa: E731
    r, k, v, logw = map(grow, (r, k, v, logw))      # padded: w = 1, k = v = 0
    w = torch.exp2(logw * LOG2E)
    bonus = (r * u[:, None, :] * k).sum(-1)         # (BH, T + pad)
    rows = _row_groups(D, G)
    S = s0.clone()
    outs = []
    for t in range(T + pad):
        rt, kt, wt, vt = r[:, t], k[:, t], w[:, t], v[:, t]
        acc = torch.zeros(BH, G, D)
        for x in range(rows.shape[1]):
            d = rows[:, x]
            acc = acc + rt[:, d, None] * S[:, d, :]
        outs.append(_halving_sum(acc) + bonus[:, t, None] * vt)
        S = wt[:, :, None] * S + kt[:, :, None] * vt[:, None, :]
    return torch.stack(outs, 1)[:, :T], S


def _dist(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _within(got, want, share):
    err, scale = _dist(got, want)
    assert err <= share * scale, f"max|got - want| {err} > {share * scale}"


def _within_chunked(got, chunked, rec):
    """Against the chunked form: CHUNK_TOL, or the chunked form's own
    distance from the recurrence plus REC_TOL, whichever is larger."""
    err, scale = _dist(got, chunked)
    lim = max(CHUNK_TOL * scale, _dist(chunked, rec)[0] + REC_TOL * scale)
    assert err <= lim, f"max|got - chunked| {err} > {lim}"


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,chunk", [(1, 128), (12, 4), (100, 20), (384, 128)])
@pytest.mark.parametrize("D", [16, 64])
def test_column_model_matches_pallas_and_recurrence(D, T, chunk, decay):
    """At the G the kernel is compiled for at D (the columns a thread holds
    change no column's arithmetic): the model against the Pallas kernel in
    interpret mode (chunked form) and the reference's token recurrence, out
    and final state, nonzero s0."""
    BH = 2
    ops = _inputs(T * D + DECAYS.index(decay), BH, T, D, decay)
    pl_o, pl_s = pallas_wkv6(*map(jnp.asarray, ops), chunk=chunk, interpret=True)
    r, k, v, logw, u, s0 = ops
    rec_o, rec_s = jref.wkv6_ref(*(jnp.asarray(a[None]) for a in (r, k, v, logw)),
                                 jnp.asarray(u), jnp.asarray(s0[None]))
    rec_o, rec_s = np.asarray(rec_o)[0], np.asarray(rec_s)[0]
    G, _ = gemm.SCAN_SPLIT[D]
    got_o, got_s = column_model(*map(torch.from_numpy, ops), G)
    assert np.isfinite(got_o.numpy()).all() and np.isfinite(got_s.numpy()).all()
    _within(got_o, rec_o, REC_TOL)
    _within(got_s, rec_s, REC_TOL)
    _within_chunked(got_o, pl_o, rec_o)
    _within_chunked(got_s, pl_s, rec_s)


@pytest.mark.parametrize("G", [2, 4, 8, 16])
def test_butterfly_lanes_give_halving_sum(G):
    """The kernel's butterfly, simulated lane by lane in fp32 (each lane
    keeps the half of its sums that its bit h of g selects, sends the other
    to lane g ^ h, adds what it receives), leaves lane g with token g's sum,
    the same bits as the model's halving sum."""
    rng = np.random.default_rng(G)
    p = rng.standard_normal((G, G)).astype(np.float32)   # [lane g, token]
    lanes = [list(row) for row in p]
    h = G // 2
    while h:
        nxt = []
        for g in range(G):
            upper = bool(g & h)
            partner = lanes[g ^ h]
            nxt.append([np.float32((lanes[g][x + h] if upper else lanes[g][x])
                                   + (partner[x] if not upper else partner[x + h]))
                        for x in range(h)])
        lanes = nxt
        h //= 2
    got = np.array([lane[0] for lane in lanes], np.float32)
    want = _halving_sum(torch.from_numpy(p.T.copy())).numpy()  # [token, lane]
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("T", [1, 40])
def test_padded_rows_leave_the_state_exactly(T):
    """w = 1, k = v = 0 rows (the kernel's ragged last tile, and the
    time-mix's end padding) change no bit of the outputs or the state: the
    model in tiles of 32 (31 or 24 padded rows) against the model with no
    padding at all."""
    ops = map(torch.from_numpy, _inputs(7, 2, T, 16, "ordinary"))
    r, k, v, logw, u, s0 = ops
    o1, s1 = column_model(r, k, v, logw, u, s0, 4)
    o2, s2 = column_model(r, k, v, logw, u, s0, 4, tile=1)
    assert torch.equal(s1, s2) and torch.equal(o1, o2)


# -- the width rule ---------------------------------------------------------

def _valid(BH, D, sms):
    G, CPT = gemm.SCAN_SPLIT[D]
    C = gemm.scan_width(BH, D, sms)
    assert (D // G) % 4 == 0 and 32 % G == 0
    assert C <= D and C % CPT == 0 and (C // CPT * G) % 32 == 0
    assert C // CPT * G <= 256 and C in gemm.scan_widths(D)
    return C


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("BH", [1, 40, 160])
@pytest.mark.parametrize("D", [16, 64])
def test_scan_geometry_is_valid_and_pure(D, BH, sms):
    """Every (BH, D, SMs) gets a width C the kernel takes (C <= D, whole
    warps of at most 256 consumer threads); the rule is a pure function
    (memoised, the same answer again)."""
    first = _valid(BH, D, sms)
    gemm.scan_width.cache_clear()
    assert _valid(BH, D, sms) == first


def test_scan_geometry_fills_the_card_at_the_prefill():
    """At the prefill's BH = 40, D = 64 on 132 SMs the rule promises one
    block an SM (120 blocks of 3 consumer warps; 12 SMs idle) and 8 columns
    on the busiest warp scheduler, the fewest any width gives (a warp holds
    32 / G * CPT = 8 columns).  16-column blocks would fill every SM, but
    put two blocks, 32 columns, on each of 28 SMs."""
    G, CPT = gemm.SCAN_SPLIT[64]
    C = _valid(40, 64, 132)
    blocks = 40 * -(-64 // C)
    consumer_warps = C // CPT * G // 32
    assert C == 24 and blocks == 120 and -(-blocks // 132) == 1
    assert C // consumer_warps == 32 // G * CPT == 8
    assert consumer_warps <= 4        # one warp on each scheduler it uses


@pytest.mark.parametrize("BH,T,want", [(1, 384, ("columns", 8)),
                                       (160, 128, ("columns", 16)),
                                       (80, 4096, ("chunks", 64))])
def test_scan_geometry_off_the_prefill(BH, T, want):
    """One sequence: the columns form, one warp of 8 columns a block, 8
    blocks.  160 sequences of 128: the columns form at C = 16, 640 blocks,
    5 on the busiest SM (10 consumer warps, 3 on its busiest scheduler, the
    fewest any width gives; 80 columns an SM, as at C = 8, in half the
    blocks).  rwkv_train's 80 sequences of 4096: the width rule would give
    C = 8, one consumer warp an SM for 4096 tokens in series, so
    ``scan_form`` takes the time-chunked form (chunks of 64, 5,120
    blocks)."""
    assert gemm.scan_form(BH, T, 64, 132) == want
    if want[0] == "columns":
        assert gemm.scan_width(BH, 64, 132) == want[1]
    else:
        assert gemm.scan_width(BH, 64, 132) == 8


# -- what the wrapper hands the kernel -------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes its
    kernel branch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(gemm, "_call", lambda *args: calls.append(args))
    monkeypatch.setattr(gemm, "sm_count", lambda device: 132)
    monkeypatch.setattr(ref, "wkv6_chunked_ref", _no_plain)
    return calls


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA request reached the plain version")


def _card_ops(BH, T, D, dtype=torch.float32):
    seq = [torch.zeros(BH, T, D, dtype=dtype).as_subclass(_OnCard) for _ in range(4)]
    u = torch.zeros(BH, D, dtype=dtype).as_subclass(_OnCard)
    s0 = torch.zeros(BH, D, D).as_subclass(_OnCard)
    return (*seq, u, s0)


@pytest.mark.parametrize("BH,T,D,chunk", [(40, 384, 64, 128), (1, 1, 64, 128),
                                          (160, 128, 64, 128), (8, 100, 16, 20),
                                          (40, 4096, 64, 128)])
def test_wrapper_hands_the_kernel_its_operands(launches, BH, T, D, chunk):
    """fp32, at shapes that take the columns form: one ``wkv6_chunked``
    launch with the operands' own pointers, the outputs', BH, T, D and the
    rule's width C for 132 SMs; counted."""
    assert gemm.scan_form(BH, T, D, 132) == ("columns", gemm.scan_width(BH, D, 132))
    ops = _card_ops(BH, T, D)
    before = wkv6_chunked.launches
    out, s_fin = wkv6_chunked(*ops, chunk=chunk)
    (args,) = launches
    assert wkv6_chunked.launches == before + 1
    assert args[:2] == ("wkv6_chunked", "wkv6_chunked")
    assert args[3:9] == tuple(a.data_ptr() for a in ops)
    assert args[9:11] == (out.data_ptr(), s_fin.data_ptr())
    assert args[11:] == (BH, T, D, gemm.scan_width(BH, D, 132))
    assert out.shape == (BH, T, D) and out.dtype == torch.float32
    assert s_fin.shape == (BH, D, D) and s_fin.dtype == torch.float32


def test_wrapper_converts_bf16_and_rounds_out_once(launches):
    """bf16 operands reach the kernel as fp32 copies (fresh pointers); out
    comes back in bf16, the final state in fp32."""
    ops = _card_ops(4, 64, 16, torch.bfloat16)
    out, s_fin = wkv6_chunked(*ops, chunk=32)
    (args,) = launches
    assert not set(args[3:8]) & {a.data_ptr() for a in ops[:5]}
    assert args[8] == ops[5].data_ptr()
    assert out.dtype == torch.bfloat16 and s_fin.dtype == torch.float32


@pytest.mark.parametrize("BH,T,D,chunk,error,match", [
    (2, 8, 32, 8, ValueError, "no kernel"),          # head size
    (2, 256, 16, 256, ValueError, "no kernel"),      # chunk > 128
    (2, 100, 16, 32, ValueError, "not a multiple"),  # T % chunk
])
def test_wrapper_refuses_before_launch(launches, BH, T, D, chunk, error, match):
    with pytest.raises(error, match=match):
        wkv6_chunked(*_card_ops(BH, T, D), chunk=chunk)
    assert launches == []


def test_wrapper_refuses_grad(launches):
    ops = list(_card_ops(2, 8, 16))
    ops[0] = torch.zeros(2, 8, 16, requires_grad=True).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_chunked(*ops, chunk=8)
    assert launches == []
