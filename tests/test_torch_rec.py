"""The port's RG-LRU recurrent block and the ``recurrentgemma_2b`` hybrid
stack (``rec, rec, local`` groups and a ``rec, rec`` suffix) on the CPU
against the JAX reference, at the smoke config (d 64, d_rnn 64, 16 gate
blocks of 4, conv width 4, window 8, vocab 512, fp32).

Inputs come from numpy with a seed; the reference's parameters carry over
with ``params_from_jax``.  Tolerances:

  * fp32: rtol 1e-5 with an absolute floor of 1e-5 times the array's
    largest magnitude (``_lm_parity.close``).  The port's scan doubles its
    offset (``_linear_scan``), the reference's ``associative_scan`` pairs
    neighbours in another order: both are held to a float64 recurrence at
    4096 steps, the port within four times the reference's own error.
  * the conv cache holds the conv's inputs ``z = h W_x``: with ``h`` and
    ``W_x`` on a dyadic grid every product and sum is exact in fp32, so it
    is compared bit for bit.
  * bf16: what bf16 costs the reference (its distance from an fp32 forward
    of the same weights), twice over, as ``test_torch_flash.py`` holds the
    deepseek smoke model.

The reference cannot decode after a prompt shorter than ``conv_width - 1``
(3) tokens: its prefill writes ``z[:, -3:]``, which is then short, and its
decode's einsum refuses it.  The port writes the conv state right-aligned
with zeros to its left (what the reference's own full-sequence conv puts
before position 0), so prompts of 1 and 2 tokens are held against the
reference's full-sequence forward, teacher forced.

Training: the scan's gradient (``_LinearScan``, the same doubling run in
reverse) passes fp64 ``gradcheck``, equals autograd through the
one-step recurrence in float64, and at 4096 steps stays within four times
the error of ``jax.grad`` through the reference's ``associative_scan``
against float64; ``_rglru``'s gradients (the gates, and a cached state
folded in) within four times the reference's own departure from a float64
oracle.  The whole model's gradients and train step are held in
``tests/test_torch_train.py``, the training driver in
``tests/test_torch_trainer.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.lm as jlm  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jB, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import grouped_row_gemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Model, blocks as tB, params_from_jax, stack as tS,
)
from _lm_parity import close, hold_lane, jitted  # noqa: E402

ARCH = "recurrentgemma_2b"
W = 4                       # the smoke config's conv width
N_DECODE = 6


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def ref():
    """The smoke model's reference parameters (numpy) and their port."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jparams = JModel(jcfg).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams,
            "np": np_params, "params": params_from_jax(np_params, cfg, "cpu")}


def _rec_block(ref, rng):
    """Layer 0's RG-LRU mixer (a ``rec`` layer), every leaf moved off its
    init (the biases non-zero), ``w_x`` on the dyadic grid of 1/64."""
    jp = jax.tree.map(lambda a: a[0], ref["np"]["blocks"]["b0"]["mix"])
    jp = {k: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
          for k, a in jp.items()}
    jp["w_x"] = np.round(jp["w_x"] * 64) / 64
    return jp, {k: _t(a) for k, a in jp.items()}


_JIT_REC = {}


def _ref_rec(jp, x, jcfg, mode: str, cache=None, write: bool = False, t=0):
    """``repro.models.blocks.apply_rec``, jitted once per mode."""
    key = (jcfg, mode, write, cache is None)
    if key not in _JIT_REC:
        _JIT_REC[key] = jax.jit(lambda p, x, c, t: jB.apply_rec(
            p, x, jcfg, jB.RunState(mode=mode, t=t, write_cache=write), c))
    return _JIT_REC[key](jp, jnp.asarray(x), cache, jnp.asarray(t))


def _dyadic(rng, shape):
    """Activations on the grid of 1/8 in [-2, 2]: with ``w_x`` on 1/64,
    h W_x is exact in fp32 in any summation order."""
    return (rng.integers(-16, 17, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 3, 64])
def test_apply_rec_prefill_then_decode_matches_reference(ref, rng, S):
    """One RG-LRU mixer: a prefill of S positions writing its cache, then
    6 decode steps, against ``repro.models.blocks.apply_rec``.  Every
    output is held to the reference's full-sequence form over the whole
    S + 6 inputs; the prefill's state ``h`` to the reference prefill's.
    The conv cache is the last 3 inputs, right-aligned, zeros to the left
    of a prompt shorter than that, bit for bit.  For S >= 3 the reference
    decodes too: outputs and caches after every step against its decode."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp, tp = _rec_block(ref, rng)
    B, dr = 2, cfg.rnn.d_rnn
    x = _dyadic(rng, (B, S + N_DECODE, cfg.d_model))
    want_full = np.asarray(_ref_rec(jp, x, jcfg, "full")[0])

    jcache = {"h": jnp.zeros((B, dr), jnp.float32),
              "conv": jnp.zeros((B, W - 1, dr), jnp.float32)}
    tcache = Model(cfg, "cpu").init_cache(B, 8)["blocks"][0]
    assert sorted(tcache) == ["conv", "h"]
    assert tcache["h"].dtype == torch.float32
    assert tuple(tcache["conv"].shape) == (B, W - 1, dr)
    jout, jcache = _ref_rec(jp, x[:, :S], jcfg, "full", jcache, write=True)
    tout, tcache = tB.apply_rec(tp, _t(x[:, :S]), cfg,
                                tB.RunState(mode="full", write_cache=True),
                                tcache)
    close(tout, jout)
    close(tout, want_full[:, :S])
    close(tcache["h"], jcache["h"])
    z = (x[:, :S].astype(np.float64) @ jp["w_x"].astype(np.float64))
    n = min(S, W - 1)
    conv = np.zeros((B, W - 1, dr))
    conv[:, W - 1 - n:] = z[:, S - n:]
    np.testing.assert_array_equal(tcache["conv"].numpy(), conv)
    np.testing.assert_array_equal(tcache["conv"][:, W - 1 - n:].numpy(),
                                  np.asarray(jcache["conv"]))
    reference_decodes = S >= W - 1
    for j in range(N_DECODE):
        x1 = x[:, S + j : S + j + 1]
        tout, tcache = tB.apply_rec(tp, _t(x1), cfg,
                                    tB.RunState(mode="decode", t=S + j),
                                    tcache)
        close(tout, want_full[:, S + j : S + j + 1])
        if reference_decodes:
            jout, jcache = _ref_rec(jp, x1, jcfg, "decode", jcache, t=S + j)
            close(tout, jout)
            close(tcache["h"], jcache["h"])
            np.testing.assert_array_equal(tcache["conv"].numpy(),
                                          np.asarray(jcache["conv"]))


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_rglru_matches_reference(ref, rng, h0):
    """``_rglru`` over (2, 37, 64): every position's state and the last,
    from zeros and with an initial state folded into the first step."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp, tp = _rec_block(ref, rng)
    z = rng.standard_normal((2, 37, cfg.rnn.d_rnn)).astype(np.float32)
    init = (rng.standard_normal((2, cfg.rnn.d_rnn)).astype(np.float32)
            if h0 else None)
    want, want_last = jax.jit(lambda z, h0: jB._rglru(z, jp, jcfg, h0))(
        jnp.asarray(z), None if init is None else jnp.asarray(init))
    got, got_last = tB._rglru(_t(z), tp, cfg,
                              None if init is None else _t(init))
    assert got.dtype == torch.float32 and tuple(got.shape) == z.shape
    close(got, want)
    close(got_last, want_last)


def test_scan_at_4096_steps_against_float64(rng):
    """The doubling scan at the chip's prompt length (4096 steps; decays
    in [0.9, 1), so the state remembers a thousand steps) against a
    float64 recurrence: its error is at most four times that of the
    reference's ``jax.lax.associative_scan`` on the same fp32 inputs."""
    a = rng.uniform(0.9, 1.0, (1, 4096, 8)).astype(np.float32)
    b = rng.standard_normal((1, 4096, 8)).astype(np.float32)
    exact = np.zeros(b.shape)
    h = np.zeros((1, 8))
    for t in range(4096):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        exact[:, t] = h

    def combine(x, y):
        return y[0] * x[0], y[0] * x[1] + y[1]

    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = tB._linear_scan(_t(a), _t(b)).double().numpy()
    e_ref = np.abs(np.asarray(want, np.float64) - exact).max()
    e_port = np.abs(got - exact).max()
    assert e_port <= 4 * e_ref, (e_port, e_ref)
    assert e_port <= 1e-5 * np.abs(exact).max()


@pytest.mark.parametrize("form", ["flash", "decode", "local_block"])
def test_one_kv_head_of_256_matches_reference(ref, rng, form):
    """recurrentgemma_2b's attention shape, 10 query heads over one KV head
    of 256 (MQA), which no other arch has: the flash scan (windowed, Q and
    KV blocks of 32 over 128 positions), ``decode_attention`` (window 16,
    per-row positions) and a ``local`` block at the smoke width with that
    head shape (a prefill of 24 through its ring of 8, then 4 decode
    steps) against the reference's, in fp32."""
    from repro.models import layers as jL
    from repro_torch.models import layers as tL

    H, hd = 10, 256
    if form == "flash":
        q = rng.standard_normal((1, 128, H, hd)).astype(np.float32)
        k, v = (rng.standard_normal((1, 128, 1, hd)).astype(np.float32)
                for _ in range(2))
        kw = dict(window=48, block_q=32, block_kv=32)
        want = jax.jit(lambda q, k, v: jL.flash_attention(q, k, v, **kw))(
            q, k, v)
        close(tL.flash_attention(_t(q), _t(k), _t(v), **kw), want)
        return
    if form == "decode":
        q = rng.standard_normal((2, 1, H, hd)).astype(np.float32)
        k, v = (rng.standard_normal((2, 64, 1, hd)).astype(np.float32)
                for _ in range(2))
        for t in (40, 63):
            want = jL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(t),
                                       window=16)
            close(tL.decode_attention(_t(q), _t(k), _t(v), t, window=16),
                  want)
        return
    change = dict(n_heads=H, n_kv_heads=1, head_dim=hd)
    cfg = dataclasses.replace(ref["cfg"], **change)
    jcfg = dataclasses.replace(ref["jcfg"], **change)
    one = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(1)))
    jblock = jax.tree.map(lambda a: a[0], one["blocks"]["b2"])
    tblock = params_from_jax(
        {"embed": one["embed"], "blocks": {"b0": jax.tree.map(
            lambda a: a[None], jblock)}},
        dataclasses.replace(cfg, block_pattern=("local",), n_groups=1,
                            suffix_pattern=()), "cpu")["blocks"][0]
    jcache = jax.tree.map(lambda a: a[0],
                          JModel(jcfg).init_cache(2, 32)["blocks"]["b2"])
    tcache = Model(cfg, "cpu").init_cache(2, 32)["blocks"][2]
    assert tuple(tcache["k"].shape) == (2, 8, 1, hd)
    step = jax.jit(lambda p, h, c, t, mode: jS.apply_block(
        p, h, jcfg, "local", jB.RunState(mode=mode, t=t,
                                         write_cache=mode == "full"), c),
        static_argnums=4)
    h = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jout, jcache = step(jblock, h, jcache, 0, "full")
    tout, tcache = tS.apply_block(tblock, _t(h), cfg,
                                  tB.RunState(mode="full", write_cache=True),
                                  tcache, "local")
    close(tout, jout)
    for t in range(24, 28):
        h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = step(jblock, h1, jcache, t, "decode")
        tout, tcache = tS.apply_block(tblock, _t(h1), cfg,
                                      tB.RunState(mode="decode", t=t),
                                      tcache, "local")
        close(tout, jout)
        close(tcache["k"], jcache["k"])
        np.testing.assert_array_equal(tcache["pos"][0].numpy(),
                                      np.asarray(jcache["pos"]))


def test_param_count_matches_reference():
    """The port counts the reference's 2.673 B parameters at FULL (and at
    the smoke config) without allocating any, over 26 layers: 8 (rec, rec,
    local) groups and a (rec, rec) suffix.  The configs themselves are
    held field for field in ``test_torch_window.py``."""
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config

    for port, want in ((get_config, j_config), (get_smoke_config, j_smoke)):
        assert (Model(port(ARCH), "cpu").param_count()
                == JModel(want(ARCH)).param_count())
    full = get_config(ARCH)
    assert 2.3e9 < full.param_count() < 3.6e9
    kinds = full.layer_kinds()
    assert len(kinds) == 26 and kinds.count("local") == 8
    assert kinds[-2:] == ["rec", "rec"]


def test_params_carry_over_and_rec_without_rnncfg_raises(ref):
    """``params_from_jax`` puts each reference leaf at its layer: every
    rec layer's ten RG-LRU leaves and its dense GeGLU FFN, the local
    layers' attention (one KV head).  A ``rec`` layer without an RnnCfg,
    and the kinds of later slices, are refused."""
    from repro_torch.models.base import check_supported

    cfg, tp = ref["cfg"], ref["params"]
    kinds = cfg.layer_kinds()
    assert len(tp["blocks"]) == len(kinds) == 8
    jb = ref["np"]["blocks"]
    for i, kind in enumerate(kinds):
        if i < 6:
            want = jax.tree.map(lambda a: a[i // 3], jb[f"b{i % 3}"])
        else:
            want = ref["np"]["suffix"][i - 6]
        got = tp["blocks"][i]
        if kind == "rec":
            assert len(list(got["mix"].keys())) == 10
        else:
            assert tuple(got["mix"]["wk"].shape) == (cfg.d_model, 1, 16)
        assert sorted(got["ffn"].keys()) == ["wi_gate", "wi_up", "wo"]
        for part in ("mix", "ffn"):
            for n, a in want[part].items():
                np.testing.assert_array_equal(got[part][n].numpy(), a)
    for change in ({"rnn": None}, {"block_pattern": ("rec", "cross")},
                   {"family": "dense"}, {"block_pattern": ("rec", "dec")}):
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(dataclasses.replace(cfg, **change))


# -- the scan's gradient ----------------------------------------------------


def _doubling_as_written(a, b):
    """The doubling scan as the forward computes it, copied here so that a
    change of the library's forward shows as a change of bits."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _loop_scan(a, b):
    """h_t = a_t h_{t-1} + b_t one step at a time (autograd's oracle)."""
    h, out = torch.zeros_like(b[:, 0]), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, 1)


def _folded(scan):
    """``scan`` from an initial state, folded in as ``_rglru`` folds it:
    b_0 += a_0 h0 on a fresh ``b``."""
    def run(a, b, h0):
        b = b * 1
        b[:, 0] += a[:, 0] * h0
        return scan(a, b)
    return run


def _scan_inputs(rng, S, dtype, B=2, dr=3):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, dr))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((B, S, dr))).to(dtype)
    h0 = torch.from_numpy(rng.standard_normal((B, dr))).to(dtype)
    return a, b, h0


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", [1, 2, 3, 7, 64])
def test_linear_scan_gradcheck(rng, S, h0):
    """``_LinearScan`` in float64 passes ``torch.autograd.gradcheck``
    (finite differences, 1e-6 steps, its default tolerances) at lengths
    of one step, a power of two and neither, from zeros and with an
    initial state folded into the first step (its gradient included)."""
    a, b, init = (x.requires_grad_() for x in
                  _scan_inputs(rng, S, torch.float64))
    if h0:
        assert torch.autograd.gradcheck(_folded(tB._linear_scan),
                                        (a, b, init))
    else:
        assert torch.autograd.gradcheck(tB._linear_scan, (a, b))


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_linear_scan_gradients_equal_the_loop_and_the_doubling(rng, h0):
    """At 37 steps the reverse scan's gradients of a, b (and h0) equal
    autograd through the one-step-at-a-time recurrence in float64 (within
    1e-12 of their max), and in fp32 autograd through the doubling scan
    itself (its ops, kept only as this oracle) within 1e-5 of their max:
    the backward runs the same doubling over the flipped sequence, the
    oracle the doubling's own adjoint, so they round in other orders."""
    for dtype, oracle, tol in ((torch.float64, _loop_scan, 1e-12),
                               (torch.float32, tB._doubling_scan, 1e-5)):
        a, b, init = (x.requires_grad_() for x in
                      _scan_inputs(rng, 37, dtype, dr=8))
        w = torch.from_numpy(rng.standard_normal(b.shape)).to(dtype)
        args = (a, b, init) if h0 else (a, b)
        fold = _folded if h0 else (lambda f: f)
        got = torch.autograd.grad((fold(tB._linear_scan)(*args) * w).sum(),
                                  args)
        want = torch.autograd.grad((fold(oracle)(*args) * w).sum(), args)
        for g, ww in zip(got, want):
            assert g.dtype == dtype
            err = float((g - ww).abs().max())
            assert err <= tol * float(ww.abs().max()), (dtype, err)


@pytest.mark.parametrize("S", [1, 2, 5, 4096])
def test_linear_scan_forward_is_the_doubling_bit_for_bit(rng, S):
    """The scan's forward, under grad and without, gives the doubling
    scan's bits (what the serving lane's prefill has computed all along)
    and keeps its input."""
    a, b, _ = _scan_inputs(rng, S, torch.float32, dr=16)
    b_in = b.clone()
    want = _doubling_as_written(a, b)
    assert torch.equal(tB._linear_scan(a, b), want)
    with torch.enable_grad():
        got = tB._linear_scan(a.requires_grad_(), b.requires_grad_())
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), want)
    assert torch.equal(b.detach(), b_in)


def test_scan_gradients_at_4096_steps_against_float64(rng):
    """The reverse scan at the chip's sequence length (4096 steps, decays
    in [0.9, 1), d_rnn 8) in fp32 against the float64 gradients of
    L = sum(w h) by the recurrence g_t = w_t + a_{t+1} g_{t+1}, da_t =
    g_t h_{t-1}, db_t = g_t: its error is at most four times that of
    ``jax.grad`` through the reference's ``jax.lax.associative_scan`` on
    the same fp32 inputs, for da and for db."""
    a = rng.uniform(0.9, 1.0, (1, 4096, 8)).astype(np.float32)
    b = rng.standard_normal((1, 4096, 8)).astype(np.float32)
    w = rng.standard_normal((1, 4096, 8)).astype(np.float32)
    a64, b64, w64 = (x[0].astype(np.float64) for x in (a, b, w))
    h = np.zeros((4097, 8))                 # h[t + 1] = h_t, h[0] = 0
    for t in range(4096):
        h[t + 1] = a64[t] * h[t] + b64[t]
    g = np.zeros((4096, 8))
    nxt = np.zeros(8)
    for t in range(4095, -1, -1):
        nxt = w64[t] + (a64[t + 1] * nxt if t < 4095 else 0.0)
        g[t] = nxt
    exact = {"a": g * h[:-1], "b": g}

    def combine(x, y):
        return y[0] * x[0], y[0] * x[1] + y[1]

    def loss(a, b):
        return jnp.sum(jax.lax.associative_scan(combine, (a, b), axis=1)[1]
                       * jnp.asarray(w))

    ja, jb = jax.jit(jax.grad(loss, (0, 1)))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (_t(x).requires_grad_() for x in (a, b))
    ga, gb = torch.autograd.grad((tB._linear_scan(ta, tb) * _t(w)).sum(),
                                 (ta, tb))
    for name, want, got in (("a", ja, ga), ("b", jb, gb)):
        e_ref = np.abs(np.asarray(want, np.float64)[0] - exact[name]).max()
        e_port = np.abs(got.double().numpy()[0] - exact[name]).max()
        assert e_port <= 4 * e_ref, (name, e_port, e_ref)
        assert e_port <= 1e-5 * np.abs(exact[name]).max(), name


def _rglru64(z, p, c, h0):
    """The reference's ``_rglru`` written out in float64 torch ops, the
    recurrence one step at a time: the float64 oracle of the tests
    below."""
    def gate(w, bias):
        nb, bw, _ = w.shape
        y = torch.einsum("...nb,nbc->...nc",
                         z.reshape(*z.shape[:-1], nb, bw), w)
        return torch.sigmoid(y.reshape(z.shape) + bias)

    log_a = -c * F.softplus(p["lam"], threshold=1e9) * gate(p["gate_a"],
                                                            p["gate_a_b"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 1e-12)) * (
        z * gate(p["gate_x"], p["gate_x_b"]))
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], 1)
    return _loop_scan(a, b)


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_rglru_gradients_match_reference(ref, rng, h0):
    """The gradients of sum(w h) through ``_rglru`` (z (2, 37, 64), the
    six RG-LRU leaves it reads and, where folded in, a cached state h0
    that requires grad: the in-place fold must leave autograd a correct
    graph) against ``jax.grad`` of the reference's ``_rglru``: each within
    four times the reference's own largest departure from the float64
    oracle ``_rglru64``, of the oracle's max (at least 1e-6 of it).  The
    gates' sqrt(1 - a^2) has an unbounded derivative as a -> 1, so fp32
    rounding there is amplified in both packages alike."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp, tp = _rec_block(ref, rng)
    names = ["lam", "gate_a", "gate_a_b", "gate_x", "gate_x_b"]
    z = rng.standard_normal((2, 37, cfg.rnn.d_rnn)).astype(np.float32)
    w = rng.standard_normal(z.shape).astype(np.float32)
    init = (rng.standard_normal((2, cfg.rnn.d_rnn)).astype(np.float32)
            if h0 else None)

    def jloss(leaves, z, init):
        return jnp.sum(jB._rglru(z, dict(jp, **leaves), jcfg, init)[0] * w)

    argnums = (0, 1, 2) if h0 else (0, 1)
    want = jax.jit(jax.grad(jloss, argnums))(
        {n: jnp.asarray(jp[n]) for n in names}, jnp.asarray(z),
        None if init is None else jnp.asarray(init))

    def port(dtype, fn):
        leaves = {n: tp[n].to(dtype).requires_grad_() for n in names}
        tz = _t(z).to(dtype).requires_grad_()
        args = [*leaves.values(), tz]
        th0 = None
        if h0:
            th0 = _t(init).to(dtype).requires_grad_()
            args.append(th0)
        out = fn(tz, dict(tp, **leaves), th0)
        grads = torch.autograd.grad((out * _t(w).to(dtype)).sum(), args)
        return [g.double().numpy() for g in grads]

    got = port(torch.float32,
               lambda z, p, h0: tB._rglru(z, p, cfg, h0)[0])
    exact = port(torch.float64, lambda z, p, h0: _rglru64(z, p, cfg.rnn.c, h0))
    want = [*(np.asarray(want[0][n], np.float64) for n in names),
            np.asarray(want[1], np.float64)] + (
                [np.asarray(want[2], np.float64)] if h0 else [])
    assert len(got) == len(want) == len(exact) == len(names) + 1 + h0
    for g, wnt, ex in zip(got, want, exact):
        scale = np.abs(ex).max()
        e_ref = np.abs(wnt - ex).max() / scale
        e_port = np.abs(g - ex).max() / scale
        assert e_port <= max(4 * e_ref, 1e-6), (e_port, e_ref)


def _loss_grads(model, params, batch, remat):
    leaves = list(params.parameters())
    with torch.enable_grad():
        for x in leaves:
            x.requires_grad_(True)
        try:
            loss = model.loss(params, batch, remat=remat)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        finally:
            for x in leaves:
                x.requires_grad_(False)


def test_remat_recomputes_the_scan_to_the_same_bits(ref, rng):
    """``Model.loss`` of the hybrid with each block recomputed in the
    backward (``torch.utils.checkpoint``, the scan's saved ``a`` and ``h``
    recomputed with it) gives the loss and every leaf's gradient of the
    run that keeps its activations, bit for bit, at 64 positions (the
    local layers' window of 8 slides)."""
    model, params = Model(ref["cfg"], "cpu"), ref["params"]
    batch = {k: _t(rng.integers(0, ref["cfg"].vocab, (2, 64))).long()
             for k in ("tokens", "targets")}
    loss, grads = _loss_grads(model, params, batch, remat=False)
    loss_r, grads_r = _loss_grads(model, params, batch, remat=True)
    assert torch.equal(loss, loss_r)
    assert len(grads) == len(list(params.parameters()))
    for g, g_r in zip(grads, grads_r):
        assert torch.equal(g, g_r)


def test_train_step_then_serving_records_no_graph(rng):
    """Two train steps of the smoke hybrid (2 microbatches, remat), then a
    prefill of 5 tokens and 3 decode steps on the trained tree: no leaf
    requires grad, no logit or cache (the rec layers' ``h`` and ``conv``,
    the local layers' rings) carries a ``grad_fn``, and every logit is
    finite."""
    from repro_torch.optim import adamw

    cfg = get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    params = model.init(0)
    opt = adamw.init_state(params)
    step = make_train_step(model, TrainHParams(microbatch=2))
    for _ in range(2):
        batch = {k: _t(rng.integers(0, cfg.vocab, (4, 32))).long()
                 for k in ("tokens", "targets")}
        params, opt, m = step(params, opt, batch)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(opt["count"]) == 2
    assert not any(p.requires_grad for p in params.parameters())
    tokens = _t(rng.integers(0, cfg.vocab, (2, 5))).long()
    lg, caches = model.prefill(params, {"tokens": tokens}, 8)
    outs = [lg]
    for t in range(5, 8):
        lg, caches = model.decode(params, torch.argmax(lg[:, -1:], -1), t,
                                  caches)
        outs.append(lg)
    assert sorted(caches["blocks"][0]) == ["conv", "h"]
    outs += [x for c in caches["blocks"] for x in c.values()]
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    assert all(bool(torch.isfinite(o).all()) for o in outs[:4])


_JIT_FORWARD = {}


def _ref_forward(jparams, jcfg, tokens):
    """The reference's full-sequence logits, jitted once per config."""
    if jcfg not in _JIT_FORWARD:
        _JIT_FORWARD[jcfg] = jax.jit(lambda p, t: jS.forward(p, jcfg, t)[0])
    return np.asarray(_JIT_FORWARD[jcfg](jparams, jnp.asarray(tokens)),
                      np.float64)


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def _ref_path(jparams, jcfg, seq, P: int, n: int) -> np.ndarray:
    """The reference's serving path: a prefill of ``seq[:, :P]``, then
    ``n - 1`` decode steps teacher forced on ``seq``; the logits that
    predicted positions P .. P + n - 1 (the reference needs P >= 3)."""
    prefill, decode = jitted(jcfg, P + n)
    lg, caches = prefill(jparams, jnp.asarray(seq[:, :P]))
    out = [lg[:, -1]]
    for j in range(n - 1):
        lg, caches = decode(jparams, jnp.asarray(seq[:, P + j : P + j + 1]),
                            jnp.asarray(P + j), caches)
        out.append(lg[:, -1])
    return np.asarray(jnp.stack(out, 1), np.float64)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_model_prefill_and_decode_from_short_prompts(ref, mode):
    """Prompts of 1 and 2 tokens (and 5, which the reference can decode
    from) through the port's prefill and 9 decode steps, teacher forced,
    against the reference's full-sequence logits over prompt + steps.

    fp32: within 1e-5, or four times the reference's own largest departure
    from the same model evaluated with float64 products where that is
    larger (``_lm_parity.hold_model``'s rule: at this config the reference
    departs from it by up to 3.9e-5 of max|logit|).

    bf16 (the same bf16 weights on both sides): the port's forward and its
    three serving paths are held to the reference's fp32 forward within
    twice what bf16 costs the reference there, the larger of its bf16
    forward's and its bf16 serving path's (prefill of 5, decode steps)
    distance from it, largest and root mean square.  Both are needed: the
    reference's jitted forward keeps fp32 inside its fusions (XLA's excess
    precision), so at this config its bf16 forward departs by 0.033 of a
    max|logit| of 0.63 and its bf16 serving path, whose steps round at
    every cache write and step boundary, by 0.20 (its bf16 forward run
    with ``XLA_FLAGS=--xla_allow_excess_precision=false`` departs by
    0.30); the port rounds every op to bf16, as it does on the card."""
    jcfg, cfg, jparams = ref["jcfg"], ref["cfg"], ref["jparams"]
    if mode == "bf16":
        change = dict(dtype="bfloat16", param_dtype="bfloat16")
        jcfg16 = dataclasses.replace(jcfg, **change)
        cfg = dataclasses.replace(cfg, **change)
        params = params_from_jax(jax.tree.map(
            lambda a: np.asarray(a, jnp.bfloat16), ref["np"]), cfg, "cpu")
        jparams16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 jparams)
        jparams32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                 jparams16)
    else:
        params = ref["params"]
        jparams32 = jparams
        c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
        p64 = params_from_jax(jax.tree.map(lambda a: a.astype(np.float64),
                                           ref["np"]), c64, "cpu")
    model = Model(cfg, "cpu")
    n = 10
    # one sequence, one forward shape: each prompt length reads its prefix
    seq = np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 5 + n - 1)).astype(np.int32)
    full = _ref_forward(jparams32, jcfg, seq)
    if mode == "fp32":
        exact_full = tS.forward(p64, c64, _t(seq))[0].numpy()
    else:
        full16 = _ref_forward(jparams16, jcfg16, seq)
        path16 = _ref_path(jparams16, jcfg16, seq, 5, n)
        cost = [full16 - full, path16 - full[:, 4 : 4 + n]]
        e_ref = max(float(np.abs(c).max()) for c in cost)
        rms_ref = max(_rms(c) for c in cost)
        port16 = tS.forward(params, cfg, _t(seq))[0].double().numpy()
        assert 0 < float(np.abs(port16 - full).max()) <= 2 * e_ref
        assert _rms(port16 - full) <= 2 * rms_ref
    for P in (1, 2, 5):
        want = full[:, P - 1 : P - 1 + n]
        lg, caches = model.prefill(params, {"tokens": _t(seq[:, :P]).long()},
                                   P + n)
        got = [lg[:, 0]]
        for j in range(n - 1):
            lg, caches = model.decode(params, _t(seq[:, P + j : P + j + 1]),
                                      P + j, caches)
            got.append(lg[:, 0])
        got = torch.stack(got, 1).double().numpy()
        if mode == "fp32":
            exact = exact_full[:, P - 1 : P - 1 + n]
            tol = max(1e-5, 4 * np.abs(want - exact).max()
                      / np.abs(exact).max())
            assert tol < 2e-4, tol
            close(got, want, tol)
        else:
            assert 0 < float(np.abs(got - want).max()) <= 2 * e_ref
            assert _rms(got - want) <= 2 * rms_ref


def _ref_greedy(jparams, jcfg, prompt, n, length):
    """Greedy generation of ``n`` tokens by the reference's full-sequence
    forward (one forward a token, zero-padded at the end to ``length``,
    which a causal model does not see)."""
    P = len(prompt)
    seq = np.zeros((1, length), np.int32)
    seq[0, :P] = prompt
    out = []
    for j in range(n):
        tok = int(np.argmax(_ref_forward(jparams, jcfg, seq)[0, P - 1 + j]))
        out.append(tok)
        if j < n - 1:
            seq[0, P + j] = tok
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("prompt_len", [1, 2, 12])
def test_lane_matches_reference(ref, prompt_len):
    """The port's decode lane, 4 tenants' requests on 2 rows (rows retire
    and re-join; 12-token prompts wrap the window of 8 in the prefill),
    held to the reference token for token where its logits decide and
    every token within the margin of its maximum (``hold_lane``).  From 3
    tokens on the reference lane generates the tokens held; below, which
    it cannot serve, greedy generation by its full-sequence forward (the
    block test holds the boundary, 3, against both)."""
    jcfg, cfg, jparams = ref["jcfg"], ref["cfg"], ref["jparams"]
    rng = np.random.default_rng(100 + prompt_len)
    # prompt + longest generation is 17 tokens at every prompt length (and
    # in the serve test), so the reference's forwards share one shape
    gens = [17 - prompt_len, 3, 5, 4]
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in gens]
    jreg = jlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=4)
    for i in range(4):
        jreg.register(f"t{i}", ref["np"]["embed"], seed=30 + i)
    if prompt_len >= W - 1:
        jlane = jrt.ContinuousDecodeLane(JModel(jcfg), jparams, jreg, rows=2,
                                         max_len=24)
        sids = [jlane.submit(f"t{i}", p, g)
                for i, (p, g) in enumerate(zip(prompts, gens))]
        jlane.run()
        want = [np.asarray(jlane.take(s)) for s in sids]
    else:
        want = [_ref_greedy(jparams, jcfg, p, g, prompt_len + max(gens))
                for p, g in zip(prompts, gens)]
    reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=4)
    reg.restore_state(*jreg.snapshot_state())
    lane = trt.ContinuousDecodeLane(Model(cfg, "cpu"), ref["params"], reg,
                                    rows=2, max_len=24, device="cpu")
    sids = [lane.submit(f"t{i}", p, g)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    lane.run()
    got = [lane.take(s) for s in sids]
    assert hold_lane(jparams, jcfg, prompts, got, want) > 0


def test_rows_are_separate_recurrences(ref, rng):
    """A batched decode step over 2 rows with other histories (prompts of
    5 and 2 tokens, other positions) equals each row stepped alone: a
    row's ``h`` and ``conv`` are its own."""
    cfg, params = ref["cfg"], ref["params"]
    model = Model(cfg, "cpu")
    caches = model.init_cache(2, 16)
    alone = []
    for r, P in enumerate((5, 2)):
        toks = _t(rng.integers(0, cfg.vocab, (1, P))).long()
        one = {"blocks": [{k: c[k][r : r + 1] for k in c}
                          for c in caches["blocks"]]}
        model.prefill_with_cache(params, {"tokens": toks}, one)
        alone.append(model.init_cache(1, 16))
        model.prefill_with_cache(params, {"tokens": toks}, alone[-1])
    tok = _t(rng.integers(0, cfg.vocab, (2, 1))).long()
    t = torch.tensor([5, 2])
    got, _ = model.decode(params, tok, t, caches)
    for r in range(2):
        want, _ = model.decode(params, tok[r : r + 1], int(t[r]), alone[r])
        close(got[r : r + 1], want)
        for c, a in zip(caches["blocks"], alone[r]["blocks"]):
            for k in c:
                close(c[k][r : r + 1], a[k])


def test_readmitted_row_starts_clean():
    """A lane of one row: a 6-token prompt with 10 generated (its window
    ring of 8 wraps, its recurrences run 16 steps), then another request
    in the same row.  The second generation equals the same request in a
    fresh lane bit for bit: the joiner starts from zeroed ``h`` and
    ``conv`` and an empty ring."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    params = model.init(0)
    embed = params["embed"].numpy()
    rng = np.random.default_rng(11)
    first = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    second = rng.integers(0, cfg.vocab, 2).astype(np.int32)

    def lane():
        reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=2)
        for i in range(2):
            reg.register(f"t{i}", embed, seed=i)
        return trt.ContinuousDecodeLane(model, params, reg, rows=1,
                                        max_len=20, device="cpu")

    reused = lane()
    a = reused.submit("t0", first, 10)
    b = reused.submit("t1", second, 9)
    reused.run()
    assert reused.take(a).shape == (10,)
    fresh = lane()
    c = fresh.submit("t1", second, 9)
    fresh.run()
    np.testing.assert_array_equal(reused.take(b), fresh.take(c))


def test_serve_lm_matches_reference_cli(capsys, ref):
    """``serve --mode lm --arch recurrentgemma_2b --smoke`` on the CPU with
    the reference's weights: ``--mole off`` and ``--mole token`` (2
    tenants) against the reference launcher's ``--mole off``, held where
    the reference decides; 12-token prompts wrap the window of 8.  The CPU
    launches no kernel."""
    flags = ["--mode", "lm", "--arch", ARCH, "--smoke", "--requests", "4",
             "--prompt-len", "12", "--gen", "5"]
    want = np.asarray(jserve.main([*flags, "--mole", "off"]))
    capsys.readouterr()
    prompts = np.asarray(SyntheticLM(DataConfig(
        vocab=ref["cfg"].vocab, seq_len=12, global_batch=4,
        seed=0)).batch(0)["tokens"])
    before = grouped_row_gemm.launches
    for mole in (["--mole", "off"], ["--mole", "token", "--tenants", "2"]):
        got = tserve.run_lm(tserve.parse_args([*flags, *mole, "--device",
                                               "cpu"]), params=ref["params"])
        assert got.shape == (4, 5) == want.shape
        assert hold_lane(ref["jparams"], ref["jcfg"], prompts, got, want) > 0
    assert grouped_row_gemm.launches == before
    assert f"arch={ARCH}" in capsys.readouterr().out
