"""The port's audio encoder-decoder (``whisper_tiny``) on the CPU against
the JAX reference, at the smoke config (d 64, 4 heads of 16, 2 encoder
layers over 24 frames of 64, 2 ``dec`` layers, vocab 512).

Weights carry over with ``params_from_jax``; every norm scale is drawn
from a seed (``_whisper_parity.drawn_norms``).  All-zero frames silence the
encoder (no bias anywhere: each block's output is 0, and so is its norm)
and so every cross sublayer, so a broken encoder or cross wiring would pass
on them: every comparison feeds random frames from the seed, and
``test_zero_frames_silence_the_cross_layers`` shows the difference.

Against the port's float64 evaluation (``dtype="float64"``; its norms and
attention scores stay fp32, as both packages compute them) the
reference's fp32 logits depart by 2.2e-5 of max|logit|, its encoder output
by 3.0e-6 and its gradients by up to 1.4e-4 of a leaf's max|g| (the
port's: 6.3e-5, 5.9e-6 and 3.1e-4).  As in ``test_torch_vlm.py``, fp32
comparisons are held at ``oracle_tol``: four times the reference's own
largest departure in the test, or the fixed bound where that is larger,
never more than ``TOL_CAP``.  Tolerances:

  * fp32 encoder output, logits and caches: ``oracle_tol`` over ``RTOL``
    1e-5 of max|reference| (``tests/_lm_parity.py``); losses at
    ``LOSS_RTOL`` 1e-5;
  * bf16 encoder output, logits and loss: the port's bf16 run against the
    reference's fp32 run within twice the reference's own bf16 distance
    from it;
  * the port's decode against its own full forward: ``DECODE_RTOL`` 1e-5
    of max|logit| (two fp32 evaluations of the same positions);
  * gradients, leaf by leaf: ``oracle_tol`` over ``GRAD_TOL`` 1e-4 of the
    leaf's max|reference|;
  * the embedding-mode equivalence: the reference test's rtol 2e-4 on the
    loss, held here at ``LOSS_RTOL``; the gradients at ``oracle_tol`` over
    ``GRAD_TOL`` of the port's raw form against its float64 evaluation;
  * the provider's frame morph against the reference's ``np.einsum``:
    ``MORPH_RTOL`` 1e-6 of max|x| (fp32 sums of 16 terms).

The train step and the launchers are held in
``test_torch_whisper_launch.py``; both files share ``_whisper_parity.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _lm_parity import RTOL, close, ref_layers  # noqa: E402
from _vlm_parity import (  # noqa: E402
    GRAD_TOL, LOSS_RTOL, close_to, grad_tols, grads_of, j_batch, leaves,
    oracle_tol, t_batch,
)
from _whisper_parity import ARCH, B, S, frames_of, make_ref  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.models import blocks as jB  # noqa: E402
from repro.models import stack as jS  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.models.base import MoLeCfg as JMoLeCfg  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.deploy import fuse_lm_params  # noqa: E402
from repro_torch.core.lm import EmbeddingMorpher  # noqa: E402
from repro_torch.data import DataConfig, Pipeline, ProviderStage  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model, ParamTree, params_from_jax  # noqa: E402
from repro_torch.models import blocks as tB  # noqa: E402
from repro_torch.models import stack as tS  # noqa: E402
from repro_torch.models import whisper as tW  # noqa: E402
from repro_torch.models.base import (  # noqa: E402
    FrontendCfg, MoECfg, MLACfg, MoLeCfg, ParamDef, check_supported,
    init_params,
)

MORPH_RTOL = 1e-6
DECODE_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    return make_ref()


def _size(node) -> int:
    if isinstance(node, ParamDef):
        return math.prod(node.shape)
    return sum(_size(v) for v in (node.values() if isinstance(node, dict)
                                  else node))


# -- the config -------------------------------------------------------------

def test_config_and_param_count_match_reference():
    """FULL and smoke field for field (the FrontendCfg as its fields) and
    their parameter counts against the reference's; FULL's published
    shape (``tests/test_models_smoke.py::test_full_config_matches_assignment``
    and ``test_param_counts_full_configs`` on the port) and its count split
    between encoder and decoder."""
    for port, jref in ((get_config, j_config), (get_smoke_config, j_smoke)):
        tc, jc = port(ARCH), jref(ARCH)
        for f in dataclasses.fields(tc):
            if f.name == "frontend":
                assert (dataclasses.asdict(tc.frontend)
                        == dataclasses.asdict(jc.frontend))
            elif f.name != "mole":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert Model(tc, "cpu").param_count() == JModel(jc).param_count()
    full = get_config(ARCH)
    assert full.n_groups == full.n_layers == full.frontend.enc_layers == 4
    assert (full.d_model, full.n_heads, full.n_kv_heads, full.d_ff,
            full.vocab) == (384, 6, 6, 1536, 51865)
    assert Model(full, "cpu").param_count() == 56_504_832
    assert Model(get_smoke_config(ARCH), "cpu").param_count() == 234_368
    sch = tW.whisper_schema(full)
    assert list(sch) == ["enc_proj", "enc_blocks", "enc_norm", "dec"]
    assert [_size(sch[k]) for k in ("enc_proj", "enc_norm")] == [147_456, 384]
    assert [_size(b) for b in sch["enc_blocks"]] == [1_770_240] * 4
    dec = sch["dec"]
    assert "frontend_proj" not in dec
    assert [_size(dec[k]) for k in ("embed", "head", "final_norm")] == [
        19_916_160, 19_916_160, 384]
    assert [_size(b) for b in dec["blocks"]] == [2_360_832] * 4
    assert list(dec["blocks"][0]) == ["norm1", "mix", "norm_cross", "cross",
                                      "norm2", "ffn"]


_AUDIO_FE = FrontendCfg(kind="audio", d_in=64, n_tokens=24, cross_gated=False,
                        enc_layers=2)


@pytest.mark.parametrize("base,change", [
    ("deepseek_7b", {"block_pattern": ("attn", "dec")}),
    ("deepseek_7b", {"frontend": _AUDIO_FE}),
    ("llama32_vision_90b", {"frontend": _AUDIO_FE}),
    (ARCH, {"block_pattern": ("dec", "cross")}),
    (ARCH, {"block_pattern": ("attn",)}),
    (ARCH, {"frontend": FrontendCfg(kind="vision", d_in=64, n_tokens=24,
                                    cross_gated=False)}),
    (ARCH, {"frontend": dataclasses.replace(_AUDIO_FE, enc_layers=0)}),
    (ARCH, {"frontend": dataclasses.replace(_AUDIO_FE, cross_gated=True)}),
    (ARCH, {"frontend": None}),
    (ARCH, {"prefix_pattern": ("dec",)}),
    (ARCH, {"sliding_window": 8}),
    (ARCH, {"moe": MoECfg(n_routed=4, n_shared=1, top_k=2, d_ff_expert=32)}),
    (ARCH, {"mla": MLACfg()}),
], ids=["dec_outside_audio", "audio_frontend_in_dense",
        "audio_frontend_in_vlm", "cross_in_audio", "attn_in_audio",
        "vision_frontend_in_audio", "no_encoder", "gated_cross",
        "no_frontend", "prefix", "window", "moe", "mla"])
def test_check_supported_refuses_what_no_audio_config_has(base, change):
    """The audio family takes ``dec`` layers alone behind an ungated audio
    frontend with an encoder; every other combination raises."""
    check_supported(get_smoke_config(ARCH))
    cfg = dataclasses.replace(get_smoke_config(base), **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        check_supported(cfg)


def test_params_from_jax_nests_the_encoder_and_decoder(ref):
    """``enc_blocks["b0"]`` (stacked on 2 layers) becomes a list of
    per-layer dicts, ``dec`` the port's per-layer decoder, ``enc_proj`` /
    ``enc_norm`` top-level leaves; every leaf equal to its slice."""
    cfg, tp, jp = ref["cfg"], ref["params"], ref["np"]
    assert list(tp.keys()) == ["enc_proj", "enc_blocks", "enc_norm", "dec"]
    np.testing.assert_array_equal(tp["enc_proj"].numpy(), jp["enc_proj"])
    assert len(tp["enc_blocks"]) == cfg.frontend.enc_layers == 2
    assert len(tp["dec"]["blocks"]) == cfg.n_layers == 2
    for i, blk in enumerate(tp["enc_blocks"]):
        want = jax.tree.map(lambda a: a[i], jp["enc_blocks"]["b0"])
        for part in ("mix", "ffn"):
            for n, a in want[part].items():
                np.testing.assert_array_equal(blk[part][n].numpy(), a)
    for i, blk in enumerate(tp["dec"]["blocks"]):
        want = jax.tree.map(lambda a: a[i], jp["dec"]["blocks"]["b0"])
        for part in ("mix", "cross", "ffn"):
            for n, a in want[part].items():
                np.testing.assert_array_equal(blk[part][n].numpy(), a)
        np.testing.assert_array_equal(blk["norm_cross"].numpy(),
                                      want["norm_cross"])
    assert sorted(tp["dec"]["blocks"][0]["ffn"].keys()) == ["wi_up", "wo"]


# -- the encoder and the dec block ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(ref, dtype):
    """``encode`` on random frames.  fp32: within ``oracle_tol`` of the
    reference's.  bf16 (weights and activations): the port's bf16 output
    within twice the reference's own bf16 distance from its fp32 one."""
    jcfg, cfg, frames = ref["jcfg"], ref["cfg"], ref["batch"]["frames"]
    want = np.asarray(jW.encode(ref["jparams"], jnp.asarray(frames), jcfg),
                      np.float64)
    assert want.shape == (B, cfg.frontend.n_tokens, cfg.d_model)
    if dtype == "float32":
        exact = tW.encode(ref["params64"], torch.from_numpy(frames),
                          ref["model64"].cfg)
        got = tW.encode(ref["params"], torch.from_numpy(frames), cfg)
        assert got.dtype == torch.float32
        close(got, want, oracle_tol([(want, exact)], RTOL))
        return
    jc16 = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
    c16 = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), ref["np"])
    ref16 = np.asarray(jW.encode(jp16, jnp.asarray(frames), jc16), np.float64)
    params = params_from_jax(jax.tree.map(np.asarray, jp16), c16, "cpu")
    got = tW.encode(params, torch.from_numpy(frames), c16)
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.double().numpy() - want).max()
            <= 2 * np.abs(ref16 - want).max())


@pytest.mark.parametrize("mode", ["full", "decode"])
def test_dec_block_matches_reference(ref, mode):
    """The first ``dec`` layer on random h and an encoder-wide context: full
    mode writes the self cache (K, V, pos) and the cross cache (the
    context's K/V) in place; a decode step reads both and never sees the
    context."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    jp = jax.tree.map(lambda a: a[0], ref["np"]["dec"]["blocks"]["b0"])
    tp = ref["params"]["dec"]["blocks"][0]
    rng = np.random.default_rng(3)
    n_ctx, max_len = cfg.frontend.n_tokens, S + 2
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((B, n_ctx, cfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(lambda a: a[0], JModel(jcfg).init_cache(
        B, max_len)["dec"]["blocks"]["b0"])
    want, jcache = jax.jit(lambda p, x, c, cache: jS.apply_block(
        p, x, jcfg, "dec",
        jB.RunState(mode="full", ctx=c, write_cache=True), cache))(
            jp, jnp.asarray(h), jnp.asarray(ctx), jcache)
    cache = init_params(tS.block_cache_schema(cfg, "dec", B, max_len),
                        torch.float32, None, "cpu")
    got, out = tS.apply_block(
        tp, torch.from_numpy(h), cfg,
        tB.RunState(mode="full", ctx=torch.from_numpy(ctx), write_cache=True),
        cache, "dec")
    assert out["self"] is cache["self"] and out["cross"] is cache["cross"]
    if mode == "decode":
        h1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jax.jit(lambda p, x, cache: jS.apply_block(
            p, x, jcfg, "dec", jB.RunState(mode="decode", t=jnp.asarray(S)),
            cache))(jp, jnp.asarray(h1), jcache)
        got, _ = tS.apply_block(tp, torch.from_numpy(h1), cfg,
                                tB.RunState(mode="decode", t=S), cache, "dec")
    close(got, want)
    for part in ("self", "cross"):
        assert sorted(cache[part]) == sorted(jcache[part])
        for name, x in cache[part].items():
            if name == "pos":
                assert (x == torch.tensor(np.asarray(jcache[part]["pos"]))[None]
                        ).all()
            else:
                close(x, jcache[part][name])
    assert float(cache["cross"]["k"].abs().max()) > 0


# -- the model --------------------------------------------------------------

def test_zero_frames_silence_the_cross_layers(ref):
    """All-zero frames give an encoder output of exactly 0 and cross K/V of
    exactly 0 (layer norm and attention carry no bias), so serving on the
    reference's zero frames cannot see the encoder; random frames move the
    logits by more than 1e-2 of their max, so the tests that feed them hold
    the encoder and every cross layer."""
    model, params, batch = Model(ref["cfg"], "cpu"), ref["params"], ref["batch"]
    zero = dict(batch, frames=np.zeros_like(batch["frames"]))
    assert float(tW.encode(params, torch.from_numpy(zero["frames"]),
                           ref["cfg"]).abs().max()) == 0.0
    inputs = {k: zero[k] for k in ("tokens", "frames")}
    _, caches = model.prefill_with_cache(params, t_batch(inputs),
                                         model.init_cache(B, S + 1))
    for c in caches["dec"]["blocks"]:
        assert float(c["cross"]["k"].abs().max()) == 0.0
        assert float(c["cross"]["v"].abs().max()) == 0.0
    live = model.logits(params, t_batch(batch))
    dead = model.logits(params, t_batch(zero))
    assert float((live - dead).abs().max()) > 1e-2 * float(live.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_reference(ref, dtype):
    """Logits and the fused loss on random frames.  fp32: within
    ``oracle_tol`` / LOSS_RTOL.  bf16: within twice the reference's own
    bf16 distance from its fp32 run."""
    jcfg, cfg, batch = ref["jcfg"], ref["cfg"], ref["batch"]
    jmodel = JModel(jcfg)
    want_lg = np.asarray(jmodel.logits(ref["jparams"], j_batch(batch)),
                         np.float64)
    want_loss = float(jmodel.loss(ref["jparams"], j_batch(batch)))
    if dtype == "float32":
        model, params = Model(cfg, "cpu"), ref["params"]
        exact = ref["model64"].logits(ref["params64"], t_batch(batch))
        close(model.logits(params, t_batch(batch)), want_lg,
              oracle_tol([(want_lg, exact)], RTOL))
        assert float(model.loss(params, t_batch(batch))) == pytest.approx(
            want_loss, rel=LOSS_RTOL)
        return
    jc16 = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
    c16 = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), ref["np"])
    j16 = JModel(jc16)
    ref_lg = np.asarray(j16.logits(jp16, j_batch(batch)), np.float64)
    ref_dist = np.abs(ref_lg - want_lg).max()
    ref_loss_dist = abs(float(j16.loss(jp16, j_batch(batch))) - want_loss)
    model = Model(c16, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp16), c16, "cpu")
    assert params["enc_proj"].dtype == torch.bfloat16
    got_lg = model.logits(params, t_batch(batch)).double().numpy()
    assert np.abs(got_lg - want_lg).max() <= 2 * ref_dist
    got_loss = float(model.loss(params, t_batch(batch)))
    assert abs(got_loss - want_loss) <= 2 * ref_loss_dist + 1e-6 * want_loss


def _serve_steps(model, params, inputs, toks, max_len):
    """``make_prefill_step`` on ``inputs``, then one decode step per entry
    of ``toks``; every call's logits and the caches after the last."""
    prefill = steps.make_prefill_step(model)
    decode = steps.make_decode_step(model)
    lg, caches = prefill(params, t_batch(inputs),
                         model.init_cache(B, max_len))
    out = [lg]
    for i, tok in enumerate(toks):
        lg, caches = decode(params, torch.tensor(tok).long(), S + i, caches)
        out.append(lg)
    return out, caches


def test_prefill_then_decode_matches_reference(ref):
    """``make_prefill_step`` on tokens and random frames, then 3 decode
    steps teacher-forced with the reference's greedy tokens: every call's
    logits, and every cache after the last step (each ``dec`` layer's
    self cache and its cross K/V of the 24 frames), against the
    reference's."""
    jcfg, cfg, batch = ref["jcfg"], ref["cfg"], ref["batch"]
    jmodel = JModel(jcfg)
    max_len, n_decode = S + 4, 3
    inputs = {k: batch[k] for k in ("tokens", "frames")}
    jlg, jc = jmodel.prefill(ref["jparams"], j_batch(inputs), max_len)
    want, toks = [jlg], []
    for i in range(n_decode):
        toks.append(np.asarray(jnp.argmax(jlg[:, 0], -1), np.int32)[:, None])
        jlg, jc = jmodel.decode(ref["jparams"], jnp.asarray(toks[-1]),
                                jnp.asarray(S + i), jc)
        want.append(jlg)
    exact, exact_caches = _serve_steps(ref["model64"], ref["params64"],
                                       inputs, toks, max_len)
    got, caches = _serve_steps(Model(cfg, "cpu"), ref["params"], inputs,
                               toks, max_len)
    jlayers = ref_layers(jc["dec"], jcfg)
    tol = oracle_tol(list(zip(want, exact)) + [
        (jb[part][n], c[part][n])
        for c, jb in zip(exact_caches["dec"]["blocks"], jlayers)
        for part in ("self", "cross") for n in c[part] if n != "pos"], RTOL)
    for g, w in zip(got, want):
        close(g, w, tol)
    assert list(caches) == ["dec"]
    for c, jb in zip(caches["dec"]["blocks"], jlayers):
        assert sorted(c) == sorted(jb) == ["cross", "self"]
        for part in ("self", "cross"):
            assert sorted(c[part]) == sorted(jb[part])
            for name, x in c[part].items():
                if name == "pos":
                    assert (x == torch.tensor(jb[part]["pos"])[None]).all()
                else:
                    close(x, jb[part][name], tol)
        assert tuple(c["cross"]["k"].shape) == (B, cfg.frontend.n_tokens,
                                                cfg.n_kv_heads, cfg.head_dim)


def test_decode_matches_forward(ref):
    """``tests/test_models_smoke.py::test_decode_matches_forward`` on the
    port: a prefill of S tokens and frames, then one decode step of token
    S, against the full forward's logits at position S (the reference's
    bound is 2e-3 absolute; here DECODE_RTOL of max|logit|), and the
    prefill's logits against the forward's at S - 1."""
    cfg, params = ref["cfg"], ref["params"]
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int64)
    frames = frames_of(rng, cfg, B)
    full = model.logits(params, t_batch({"tokens": toks, "frames": frames}))
    lg, caches = steps.make_prefill_step(model)(
        params, t_batch({"tokens": toks[:, :S], "frames": frames}),
        model.init_cache(B, S + 4))
    close(lg[:, 0], full[:, S - 1], DECODE_RTOL)
    dec, _ = steps.make_decode_step(model)(
        params, torch.from_numpy(toks[:, S:]), S, caches)
    close(dec[:, 0], full[:, S], DECODE_RTOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_reference(ref, remat):
    """Every leaf's gradient, ``enc_proj``, the encoder blocks, ``enc_norm``
    and each ``dec`` layer's cross weights included, against
    ``jax.grad``, with remat on and off (the encoder's output reaches the
    recomputed decoder blocks through the run state)."""
    jmodel, cfg = JModel(ref["jcfg"]), ref["cfg"]
    batch = ref["batch"]
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, j_batch(batch), remat=remat)))(ref["jparams"])
    loss, grads = grads_of(Model(cfg, "cpu"), ref["params"], t_batch(batch),
                           remat)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = leaves(jg, cfg)
    assert sorted(grads) == sorted(want)
    for name in ("enc_proj", "enc_norm", "enc_blocks.0.mix.wq",
                 "dec.blocks.0.cross.wk", "dec.blocks.1.cross.ctx_norm",
                 "dec.blocks.1.norm_cross"):
        assert float(want[name].abs().max()) > 0, name
    tol, _ = grad_tols(ref, want)
    for name, g in grads.items():
        close_to(g, want[name], tol, name)


# -- embedding-mode MoLe ------------------------------------------------------

def test_embedding_mole_frames_equivalence(ref):
    """``tests/test_mole_lm.py::test_embedding_mole_vlm_equivalence``'s form
    on the frames: the loss of the raw params on raw frames equals that of
    ``fuse_lm_params(..., embed_morpher=em)`` (``enc_proj`` becomes ``M^-1
    W``) on the provider stage's morphed frames (K4's plain version), at
    LOSS_RTOL.  At step 1 every gradient agrees but ``enc_proj``'s, which
    is ``M^T`` times the raw one, block by block: each within
    ``oracle_tol`` of the raw form's own departure from the float64
    evaluation (two fp32 evaluations of one function agree no closer than
    each is to it; the raw form departs by up to 3.1e-4 of a leaf's
    max|g|)."""
    cfg, params = ref["cfg"], ref["params"]
    model = Model(cfg, "cpu")
    em = EmbeddingMorpher.create(3, d_in=cfg.frontend.d_in, kappa=4, d_out=None)
    raw = t_batch(ref["batch"])
    morphed = ProviderStage(embed_morpher=em, device="cpu")(raw)
    assert not torch.allclose(morphed["frames"], raw["frames"])
    fused = ParamTree(fuse_lm_params(params, cfg, embed_morpher=em))
    assert (fused["dec"]["embed"].data_ptr()
            == params["dec"]["embed"].data_ptr())
    loss_raw, g_raw = grads_of(model, params, raw, remat=True)
    loss_mor, g_mor = grads_of(model, fused, morphed, remat=True)
    assert float(loss_mor) == pytest.approx(float(loss_raw), rel=LOSS_RTOL)
    _, exact = grads_of(ref["model64"], ref["params64"], raw, remat=False)
    tol = oracle_tol([(g_raw[n].numpy(), exact[n]) for n in g_raw], GRAD_TOL)
    for name, g in g_raw.items():
        if name != "enc_proj":
            close_to(g_mor[name], g, tol, name)
    core = torch.from_numpy(em.core.matrix).double()
    q, d = em.core.q, cfg.d_model
    want = torch.matmul(core.T, g_raw["enc_proj"].double().reshape(
        em.core.kappa, q, d)).reshape(-1, d)
    close_to(g_mor["enc_proj"], want.numpy(), tol, "enc_proj")


# -- the data pipeline --------------------------------------------------------

def test_frontend_stub_matches_reference_bytes():
    """``tests/test_data.py::test_frontend_stub_shapes[whisper_tiny]`` on the
    port: ``frames`` with the same bytes, shape and dtype as the
    reference's stub."""
    cfg = get_smoke_config(ARCH)
    d = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    jd = JDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    pipe, jpipe = Pipeline(d, model_cfg=cfg), JPipeline(jd, model_cfg=j_smoke(ARCH))
    for _ in range(2):
        got, want = next(pipe), next(jpipe)
        assert sorted(got) == sorted(want) == ["frames", "targets", "tokens"]
        assert got["frames"].shape == (2, cfg.frontend.n_tokens,
                                       cfg.frontend.d_in)
        assert got["frames"].dtype == want["frames"].dtype == np.float32
        assert got["frames"].tobytes() == want["frames"].tobytes()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_provider_stage_frame_morph_matches_reference():
    """``--mole embedding`` (kappa 4): the port's provider stage morphs the
    frames through K4 (its plain version on the CPU) where the reference
    uses ``np.einsum``; tokens pass unmorphed.  Within MORPH_RTOL of
    max|x| of the reference and of a float64 product."""
    mole = dict(enabled=True, mode="embedding", kappa=4, seed=5)
    cfg = dataclasses.replace(get_smoke_config(ARCH), mole=MoLeCfg(**mole))
    jcfg = dataclasses.replace(j_smoke(ARCH), mole=JMoLeCfg(**mole))
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    got = next(Pipeline(DataConfig(**kw), model_cfg=cfg, device="cpu"))
    want = next(JPipeline(JDataConfig(**kw), model_cfg=jcfg))
    assert isinstance(got["frames"], torch.Tensor)
    assert got["frames"].dtype == torch.float32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    x = next(Pipeline(DataConfig(**kw), model_cfg=get_smoke_config(ARCH)))
    x = x["frames"].astype(np.float64)
    core = EmbeddingMorpher.create(5, d_in=64, kappa=4).core.matrix
    exact = (x.reshape(2, -1, 4, 16) @ core.astype(np.float64)).reshape(x.shape)
    lim = MORPH_RTOL * np.abs(x).max()
    for other in (want["frames"], exact):
        np.testing.assert_allclose(got["frames"].numpy(), other, rtol=0,
                                   atol=lim)
