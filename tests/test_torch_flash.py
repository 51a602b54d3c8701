"""The port's chunked long-sequence attention (``repro_torch.models.layers``
``flash_attention`` and the ``attention`` dispatch) and the dense-attention
models that reach it, on the CPU against the JAX reference
(``repro.models.layers``, ``repro.models.stack``).

Inputs come from numpy with a seed; model weights carry over with
``params_from_jax``.  Tolerances:

  * fp32 attention: the port's flash against the reference's flash at the
    same blocks within ``RTOL`` 1e-5 of max|reference| (both keep fp32
    scores, normaliser and accumulator; they sum in other orders); against
    the dense oracle at the reference's own atol 2e-3
    (``tests/test_layers.py``);
  * bf16 attention: two bf16 units in the last place of max|reference|
    (each side rounds the output once, and ``p`` once per block);
  * fp32 model logits and caches at 1024 positions: ``LONG_RTOL`` 1e-4
    with an absolute floor of 1e-4 x max.  At that length the port's dense
    path already differs from the reference's dense path by 2.9e-5 of
    max|logit| (softmax sums over 1024 keys in other orders), above the
    1e-5 that ``test_torch_models.py`` holds at 6 positions;
  * the bf16 model: see :func:`test_bf16_forward_parity`.
"""
import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import layers as jL, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Model, layers as tL, params_from_jax, stack as tS,
)
from _lm_parity import ref_layers  # noqa: E402

RTOL = 1e-5
LONG_RTOL = 1e-4
ARCHS = ["deepseek_7b", "phi3_mini_3p8b", "command_r_35b", "gemma2_27b"]


def _qkv(rng, B, Sq, Skv, Hq, Hkv, hd):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                               (B, Skv, Hkv, hd)))


def _both(fn_name, q, k, v, **kw):
    """The reference's and the port's ``fn_name`` on the same numpy inputs,
    both as float64 numpy arrays."""
    want = getattr(jL, fn_name)(*map(jnp.asarray, (q, k, v)), **kw)
    got = getattr(tL, fn_name)(*map(torch.from_numpy, (q, k, v)), **kw)
    return got.double().numpy(), np.asarray(want, np.float64)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        rtol=rtol, atol=rtol * float(np.abs(want).max()),
    )


def _bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("cap", [None, 20.0])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_flash_matches_reference(rng, window, cap, Hq, Hkv):
    """``tests/test_layers.py::test_flash_matches_dense``'s cases: window,
    soft-cap and GQA, four Q blocks by four KV blocks."""
    q, k, v = _qkv(rng, 2, 64, 64, Hq, Hkv, 16)
    kw = dict(causal=True, window=window, logit_cap=cap)
    got, want = _both("flash_attention", q, k, v, block_q=16, block_kv=16, **kw)
    _close(got, want)
    dense = tL.dense_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got, dense.double().numpy(), atol=2e-3)


@settings(max_examples=15, deadline=None)
@given(
    s_blocks=st.integers(1, 4), bq=st.sampled_from([8, 16]),
    bkv=st.sampled_from([8, 32]), seed=st.integers(0, 2**31 - 1),
)
def test_flash_block_shape_invariance(s_blocks, bq, bkv, seed):
    """The output does not depend on the tiling: at every block shape the
    port equals the reference's flash at that shape and the dense oracle."""
    g = np.random.default_rng(seed)
    q, k, v = _qkv(g, 1, 32 * s_blocks, 32 * s_blocks, 2, 2, 8)
    got, want = _both("flash_attention", q, k, v, block_q=bq, block_kv=bkv)
    _close(got, want)
    dense = tL.dense_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got, dense.double().numpy(), atol=2e-3)


def test_fully_masked_rows_give_no_nan(rng):
    """A window of 1 with blocks of 8: the running-max guards keep every
    row finite, as the reference's do, and the values agree."""
    q, k, v = _qkv(rng, 1, 32, 32, 2, 2, 8)
    got, want = _both("flash_attention", q, k, v, causal=True, window=1,
                      block_q=8, block_kv=8)
    assert np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("window", [None, 12])
def test_flash_q_offset(rng, window):
    """A chunk of 16 queries at absolute positions 32..47 against 48 keys
    (chunked prefill): equal to the reference's flash, and to dense
    attention at those query positions."""
    q, k, v = _qkv(rng, 2, 16, 48, 4, 2, 8)
    kw = dict(window=window, q_offset=32)
    got, want = _both("flash_attention", q, k, v, block_q=8, block_kv=16, **kw)
    _close(got, want)
    dense = tL.dense_attention(
        *map(torch.from_numpy, (q, k, v)), window=window,
        q_pos=32 + torch.arange(16), kv_pos=torch.arange(48),
    )
    np.testing.assert_allclose(got, dense.double().numpy(), atol=2e-3)


def test_flash_skips_only_future_blocks(rng, monkeypatch):
    """Causal: Q block i reads KV blocks 0..i and no later one (their
    products are never formed); without ``causal`` every block is read.
    The values equal the reference's, which computes every block."""
    q, k, v = _qkv(rng, 1, 64, 64, 2, 2, 8)
    shapes = []
    real = torch.matmul

    def counted(a, b):
        shapes.append(tuple(b.shape[-2:]))
        return real(a, b)

    for causal, want_products in ((True, 2 * (1 + 2 + 3 + 4)), (False, 2 * 16)):
        shapes.clear()
        monkeypatch.setattr(torch, "matmul", counted)
        got = tL.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_q=16, block_kv=16)
        monkeypatch.setattr(torch, "matmul", real)
        assert len(shapes) == want_products
        want = jL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  block_q=16, block_kv=16)
        _close(got.double().numpy(), want)


def test_flash_skips_blocks_before_the_window(rng, monkeypatch):
    """Causal with a window of 16, blocks of 16: Q block i reads KV blocks
    i - 1 and i only (the earlier ones lie before every row's window, the
    later ones in its future), and the values equal the reference's, which
    computes every block."""
    q, k, v = _qkv(rng, 1, 64, 64, 2, 2, 8)
    shapes = []
    real = torch.matmul

    def counted(a, b):
        shapes.append(tuple(b.shape[-2:]))
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", counted)
    got = tL.flash_attention(*map(torch.from_numpy, (q, k, v)), window=16,
                             block_q=16, block_kv=16)
    monkeypatch.setattr(torch, "matmul", real)
    assert len(shapes) == 2 * (1 + 2 + 2 + 2)
    want = jL.flash_attention(*map(jnp.asarray, (q, k, v)), window=16,
                              block_q=16, block_kv=16)
    _close(got.double().numpy(), want)


@pytest.mark.parametrize("dense_max_seq,path", [(32, "dense"), (31, "flash")])
def test_attention_dispatch_at_the_limit(rng, monkeypatch, dense_max_seq, path):
    """Just at ``dense_max_seq`` (32 x 32 score entries) the dispatch runs
    dense attention, just above it the flash scan, in both packages, and
    the two agree."""
    q, k, v = _qkv(rng, 2, 32, 32, 4, 2, 8)
    ran = []
    real = tL.flash_attention
    monkeypatch.setattr(tL, "flash_attention",
                        lambda *a, **kw: ran.append(1) or real(*a, **kw))
    kw = dict(dense_max_seq=dense_max_seq, block_kv=16, logit_cap=5.0)
    got, want = _both("attention", q, k, v, **kw)
    assert bool(ran) == (path == "flash")
    _close(got, want)


@pytest.mark.parametrize("Sq,Skv,bq,bkv", [(48, 48, 32, 16), (32, 48, 16, 32)])
def test_flash_divisibility_assertion(rng, Sq, Skv, bq, bkv):
    """Blocks that do not divide the sequence raise the reference's
    AssertionError with the same (Sq, block_q, Skv, block_kv)."""
    q, k, v = _qkv(rng, 1, Sq, Skv, 2, 2, 8)
    errors = []
    for mod, conv in ((jL, jnp.asarray), (tL, torch.from_numpy)):
        with pytest.raises(AssertionError) as exc:
            mod.flash_attention(*map(conv, (q, k, v)), block_q=bq, block_kv=bkv)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] == str((Sq, bq, Skv, bkv))


def test_flash_bf16_matches_reference(rng):
    """bf16 operands: both products in fp32, ``p`` rounded to bf16 before
    its product, one rounding of the output: within two bf16 ulps of the
    reference's flash; and no further from an fp32 dense result than the
    reference's bf16 flash, within one ulp."""
    q, k, v = _qkv(rng, 1, 256, 256, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    want = np.asarray(jL.flash_attention(jq, jk, jv, block_q=64, block_kv=128)
                      .astype(jnp.float32), np.float64)
    out = tL.flash_attention(tq, tk, tv, block_q=64, block_kv=128)
    assert out.dtype == torch.bfloat16
    got = out.double().numpy()
    ulp = _bf16_ulp(float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 2 * ulp
    exact = tL.dense_attention(tq.float(), tk.float(), tv.float()).double().numpy()
    assert (float(np.abs(got - exact).max())
            <= float(np.abs(want - exact).max()) + ulp)


# ---------------------------------------------------------------------------
# Models whose prefill takes the flash path
# ---------------------------------------------------------------------------

S_FLASH, LIMIT, BLOCK_KV = 1024, 256, 256


def _flash_cfgs(arch):
    """The smoke config in both packages with ``dense_attn_max_seq`` lowered
    to 256 and ``flash_block_kv`` 256: a 1024-token prompt runs the flash
    scan as 2 Q blocks of 512 by 4 KV blocks."""
    change = dict(dense_attn_max_seq=LIMIT, flash_block_kv=BLOCK_KV)
    return (dataclasses.replace(get_smoke_config(arch), **change),
            dataclasses.replace(j_smoke(arch), **change))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_through_flash_match_reference(rng, monkeypatch,
                                                           arch):
    """``forward`` logits and ``prefill_with_cache`` logits and caches of a
    2-layer smoke model at 2 x 1024 tokens against the reference's
    ``forward`` and ``Model.prefill``, with the flash scan on both sides:
    the port runs it once per layer and call."""
    cfg, jcfg = _flash_cfgs(arch)
    jparams = JModel(jcfg).init(jax.random.key(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    tokens = rng.integers(0, cfg.vocab, (2, S_FLASH)).astype(np.int32)
    calls = []
    real = tL.flash_attention
    monkeypatch.setattr(tL, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    jl, _ = jS.forward(jparams, jcfg, jnp.asarray(tokens))
    tl_, _ = tS.forward(tparams, cfg, torch.from_numpy(tokens))
    _close(tl_, jl, LONG_RTOL)
    assert len(calls) == cfg.n_layers

    max_len = S_FLASH + 4
    jlog, jc = JModel(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                    max_len)
    tm = Model(cfg, "cpu")
    tlog, tc = make_prefill_step(tm)(
        tparams, {"tokens": torch.from_numpy(tokens)}, tm.init_cache(2, max_len))
    _close(tlog, jlog, LONG_RTOL)
    assert len(calls) == 2 * cfg.n_layers
    for c, jb, kind in zip(tc["blocks"], ref_layers(jc, jcfg),
                           cfg.layer_kinds()):
        for name in ("k", "v"):
            _close(c[name], jb[name], LONG_RTOL)
        if kind == "local":
            # the ring holds the last ``window`` positions, p in slot p % window
            held = np.arange(S_FLASH - cfg.sliding_window, S_FLASH)
            want_pos = np.empty(cfg.sliding_window, np.int64)
            want_pos[held % cfg.sliding_window] = held
        else:
            want_pos = np.concatenate([np.arange(S_FLASH),
                                       -np.ones(max_len - S_FLASH, np.int64)])
        assert (c["pos"] == torch.from_numpy(want_pos)).all()
        np.testing.assert_array_equal(jb["pos"], want_pos)


@pytest.mark.parametrize("seq", [32, 2048])
def test_bf16_forward_parity(rng, seq):
    """The ``deepseek_7b`` smoke config in bf16 on both sides, the same bf16
    weights; at 4 x 32 tokens (dense attention) and at 2 x 2048 tokens,
    which the default ``dense_attn_max_seq`` of 1024 sends through the
    flash scan.  bf16 rounds at other places in the two frameworks, so the
    port is held not to the reference's bf16 logits but to what bf16 costs
    the reference: ``e_ref = max|ref_bf16 - ref_fp32|``, its own distance
    from an fp32 forward of the same weights.  The bound is ``2 e_ref`` on
    the port's distance from that fp32 forward, in the largest deviation,
    and twice the reference's root mean square deviation.

    Tokens are judged position by position from the fp32 forward's
    top-1/top-2 gap: where it exceeds twice the bound no admitted error
    can reorder the top two, and the port's argmax is the fp32 argmax;
    everywhere the port's pick lies within twice the bound of the fp32
    maximum.  The reference's bf16 forward is held to the same standard.
    At this config bf16 costs the reference 13% (32 tokens) and 38% (2048)
    of max|logit| at its worst position, more than any top-1/top-2 gap of
    the fp32 forward, so no position is
    decided by that margin and the tokens are held by the second check
    alone; the test counts the decided positions and asserts nothing
    about them when there are none."""
    arch = "deepseek_7b"
    change = dict(dtype="bfloat16", param_dtype="bfloat16")
    cfg16 = dataclasses.replace(get_smoke_config(arch), **change)
    jcfg16 = dataclasses.replace(j_smoke(arch), **change)
    jcfg32 = j_smoke(arch)
    assert (seq > cfg16.dense_attn_max_seq) == (seq == 2048)
    jparams = JModel(jcfg16).init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg16,
                              device="cpu")
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    batch = 4 if seq == 32 else 2
    tokens = rng.integers(0, cfg16.vocab, (batch, seq)).astype(np.int32)

    ref16 = np.asarray(jS.forward(jparams, jcfg16, jnp.asarray(tokens))[0],
                       np.float64)
    ref32 = np.asarray(jS.forward(p32, jcfg32, jnp.asarray(tokens))[0],
                       np.float64)
    port16 = tS.forward(tparams, cfg16, torch.from_numpy(tokens))[0]
    assert port16.dtype == torch.float32
    port16 = port16.double().numpy()

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    e_ref = float(np.abs(ref16 - ref32).max())
    assert e_ref > 0
    bound = 2 * e_ref
    assert float(np.abs(port16 - ref32).max()) <= bound
    assert rms(port16 - ref32) <= 2 * rms(ref16 - ref32)

    top2 = np.sort(ref32, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * bound
    for got in (port16, ref16):
        pick = got.argmax(-1)
        np.testing.assert_array_equal(pick[decided], ref32.argmax(-1)[decided])
        picked = np.take_along_axis(ref32, pick[..., None], -1)[..., 0]
        assert float((top2[..., 1] - picked).max()) <= 2 * bound
