"""The port's vision-language stack (``llama32_vision_90b``) on the CPU
against the JAX reference, at the smoke config (d 64, 8 heads over 2 KV
heads, 2 groups of four attention layers and one gated cross layer, a
frontend of 16 patches of 48).

Weights carry over with ``params_from_jax``.  The reference draws both
gates of every cross layer as zeros, so a cross layer adds exactly 0 at
init and a broken cross-attention would pass unseen: every comparison but
the ``serve`` test sets the gates (and ``ctx_norm``) to values drawn from a
seed and feeds random patches.  The ``serve`` test runs the reference's
own ``run_lm``, with its zero gates and all-zero patches.

The smoke model with live gates is ill-conditioned in fp32: against the
same model evaluated with float64 products (the port with
``dtype="float64"``; its norms and attention scores stay in fp32, as both
packages compute them), the reference's logits depart by 6.3e-5 of
max|logit| and its gradients by up to 2.0e-3 of a leaf's max|g| (the
port's by 7.4e-5 and 2.9e-3; with the gates at zero, 5.4e-5 and 1.4e-3 for
the reference).  So, as ``_lm_parity.hold_model`` does, fp32 comparisons
of logits, caches and gradients are held at ``oracle_tol``: four times the
reference's own largest departure from that float64 evaluation in the
test, or the fixed bound where that is larger, and never more than
``TOL_CAP``.  Tolerances:

  * fp32 logits and caches: ``oracle_tol`` over ``RTOL`` 1e-5 of
    max|reference| (``tests/_lm_parity.py``); losses at ``LOSS_RTOL`` 1e-5;
  * bf16 logits and loss: the port's bf16 run against the reference's fp32
    run within twice the reference's own bf16 distance from it;
  * gradients, leaf by leaf: ``oracle_tol`` over ``GRAD_TOL`` 1e-4 of the
    leaf's max|reference| (``tests/test_torch_train.py``'s bound);
  * the embedding-mode equivalence: the reference test's rtol 2e-4 on the
    loss, held here at ``LOSS_RTOL`` 1e-5; the gradients at the gradient
    test's ``oracle_tol``;
  * the provider's morph against the reference's ``np.einsum``:
    ``MORPH_RTOL`` 1e-6 of max|x| (two fp32 sums of 12 terms);
  * generations: ``_lm_parity.hold_lane``'s tie-margin rule.

The train step and the launchers (``launch/train.py``, ``serve --mode lm``)
are held in ``test_torch_vlm_launch.py``; both files share
``_vlm_parity.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _lm_parity import RTOL, close, ref_layers  # noqa: E402
from _vlm_parity import (  # noqa: E402
    ARCH, B, CROSS, GRAD_TOL, LOSS_RTOL, S, close_to, grad_tols, grads_of,
    j_batch, leaves, make_ref, oracle_tol, t_batch,
)
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.models import blocks as jB  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.models.base import MoLeCfg as JMoLeCfg  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.deploy import fuse_lm_params  # noqa: E402
from repro_torch.core.lm import EmbeddingMorpher  # noqa: E402
from repro_torch.data import DataConfig, Pipeline, ProviderStage  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Model, ParamTree, params_from_jax  # noqa: E402
from repro_torch.models import blocks as tB  # noqa: E402
from repro_torch.models.base import MoLeCfg, init_params  # noqa: E402

MORPH_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    return make_ref()


# -- the config -------------------------------------------------------------

def test_config_and_param_count_match_reference():
    """FULL and smoke field for field (the FrontendCfg as its fields), and
    the parameter count of both, counted from the schema."""
    for port, jref in ((get_config, j_config), (get_smoke_config, j_smoke)):
        tc, jc = port(ARCH), jref(ARCH)
        for f in dataclasses.fields(tc):
            if f.name == "frontend":
                assert (dataclasses.asdict(tc.frontend)
                        == dataclasses.asdict(jc.frontend))
            elif f.name != "mole":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert Model(tc, "cpu").param_count() == JModel(jc).param_count()
    assert Model(get_config(ARCH), "cpu").param_count() == 87_729_872_936
    assert get_config(ARCH).n_layers == 100


# -- the cross-attention mixer -----------------------------------------------

@pytest.mark.parametrize("mode", ["full", "decode"])
def test_apply_cross_matches_reference(ref, mode):
    """The first cross layer's mixer on random h and context (d_model
    wide, as after ``frontend_proj``): full mode writes K and V into the
    cache in place; decode reads them and never sees the context."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    jp = jax.tree.map(lambda a: a[0], ref["np"]["blocks"][CROSS]["mix"])
    tp = ref["params"]["blocks"][4]["mix"]
    rng = np.random.default_rng(3)
    n_ctx = cfg.frontend.n_tokens
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((B, n_ctx, cfg.d_model)).astype(np.float32)
    jcache = {k: jnp.zeros((B, n_ctx, cfg.n_kv_heads, cfg.head_dim))
              for k in ("k", "v")}
    want, jcache = jB.apply_cross(
        jp, jnp.asarray(h), jcfg,
        jB.RunState(mode="full", ctx=jnp.asarray(ctx), write_cache=True),
        jcache)
    cache = init_params(tB.cache_cross(cfg, B), torch.float32, None, "cpu")
    got, out_cache = tB.apply_cross(
        tp, torch.from_numpy(h), cfg,
        tB.RunState(mode="full", ctx=torch.from_numpy(ctx), write_cache=True),
        cache)
    assert out_cache is cache
    for k in ("k", "v"):
        close(cache[k], jcache[k])
    if mode == "decode":
        h1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, _ = jB.apply_cross(jp, jnp.asarray(h1), jcfg,
                                 jB.RunState(mode="decode", t=jnp.asarray(S)),
                                 jcache)
        got, _ = tB.apply_cross(tp, torch.from_numpy(h1), cfg,
                                tB.RunState(mode="decode", t=S), cache)
    assert float(np.abs(np.asarray(want)).max()) > 0
    close(got, want)


# -- the model --------------------------------------------------------------

def test_gates_are_live(ref):
    """With the drawn gates the cross layers move the logits, and random
    patches against zero patches move them too: the comparisons below
    hold the cross layers, not a stack that skips them."""
    model, params, batch = Model(ref["cfg"], "cpu"), ref["params"], ref["batch"]
    base = model.logits(params, t_batch(batch))
    zero = model.logits(params, t_batch(dict(
        batch, patches=np.zeros_like(batch["patches"]))))
    assert float((base - zero).abs().max()) > 1e-2 * float(base.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_loss_match_reference(ref, dtype):
    """Logits and the fused loss on random patches.  fp32: within RTOL /
    LOSS_RTOL.  bf16 (weights and activations): the port's bf16 run lies
    within twice the reference's own bf16 distance from the reference's
    fp32 run."""
    jcfg, cfg, batch = ref["jcfg"], ref["cfg"], ref["batch"]
    jmodel = JModel(jcfg)
    want_lg = np.asarray(jmodel.logits(ref["jparams"], j_batch(batch)), np.float64)
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
    assert params["frontend_proj"].dtype == torch.bfloat16
    got_lg = model.logits(params, t_batch(batch)).double().numpy()
    assert np.abs(got_lg - want_lg).max() <= 2 * ref_dist
    got_loss = float(model.loss(params, t_batch(batch)))
    assert abs(got_loss - want_loss) <= 2 * ref_loss_dist + 1e-6 * want_loss


def test_prefill_then_decode_matches_reference(ref):
    """``make_prefill_step`` on tokens and patches, then 3 decode steps
    teacher-forced with the reference's greedy tokens: every call's
    logits, and every cache after the last step (the cross layers' K/V of
    the 16 patches among them), against the reference's."""
    jcfg, cfg, batch = ref["jcfg"], ref["cfg"], ref["batch"]
    jmodel = JModel(jcfg)
    max_len, n_decode = S + 4, 3
    inputs = {k: batch[k] for k in ("tokens", "patches")}
    jlg, jc = jmodel.prefill(ref["jparams"], j_batch(inputs), max_len)
    want, toks = [jlg], []
    for i in range(n_decode):
        toks.append(np.asarray(jnp.argmax(jlg[:, 0], -1), np.int32)[:, None])
        jlg, jc = jmodel.decode(ref["jparams"], jnp.asarray(toks[-1]),
                                jnp.asarray(S + i), jc)
        want.append(jlg)

    def run(model, params):
        prefill = steps.make_prefill_step(model)
        decode = steps.make_decode_step(model)
        lg, caches = prefill(params, t_batch(inputs), model.init_cache(B, max_len))
        out = [lg]
        for i, tok in enumerate(toks):
            lg, caches = decode(params, torch.tensor(tok).long(), S + i,
                                caches)
            out.append(lg)
        return out, caches

    exact, exact_caches = run(ref["model64"], ref["params64"])
    got, caches = run(Model(cfg, "cpu"), ref["params"])
    jlayers = ref_layers(jc, jcfg)
    tol = oracle_tol(list(zip(want, exact)) + [
        (jb[n], c[n]) for c, jb in zip(exact_caches["blocks"], jlayers)
        for n in c if n != "pos"], RTOL)
    for g, w in zip(got, want):
        close(g, w, tol)
    for c, jb, kind in zip(caches["blocks"], jlayers, cfg.layer_kinds()):
        assert sorted(c) == sorted(jb)
        for name, x in c.items():
            if name == "pos":
                assert (x == torch.tensor(jb["pos"])[None]).all()
            else:
                close(x, jb[name], tol)
        if kind == "cross":
            assert tuple(c["k"].shape) == (B, cfg.frontend.n_tokens,
                                           cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_reference(ref, remat):
    """Every leaf's gradient, ``frontend_proj``, the cross layers' weights,
    ``ctx_norm`` and the 0-d gates included, against ``jax.grad``, with
    remat on and off (the context reaches the recomputed blocks through
    the run state, not as an input of the checkpoint)."""
    jmodel, cfg = JModel(ref["jcfg"]), ref["cfg"]
    batch = ref["batch"]
    jloss, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, j_batch(batch), remat=remat))(ref["jparams"])
    loss, grads = grads_of(Model(cfg, "cpu"), ref["params"], t_batch(batch), remat)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    want = leaves(jg, cfg)
    assert sorted(grads) == sorted(want)
    for name in ("frontend_proj", "blocks.4.mix.gate_attn",
                 "blocks.9.mix.gate_ffn", "blocks.4.mix.ctx_norm"):
        assert float(want[name].abs().max()) > 0, name
    tol, _ = grad_tols(ref, want)
    for name, g in grads.items():
        close_to(g, want[name], tol, name)


# -- embedding-mode MoLe ------------------------------------------------------

def test_embedding_mole_vlm_equivalence(ref):
    """``tests/test_mole_lm.py::test_embedding_mole_vlm_equivalence`` on the
    port, with live gates: the loss of the raw params on raw patches equals
    that of ``fuse_lm_params(..., embed_morpher=em)`` (``AugProj = M^-1
    W_in``) on the provider stage's morphed patches (K4's plain version),
    at LOSS_RTOL (the reference test's bound is 2e-4).  At step 1 every
    gradient agrees but ``frontend_proj``'s, which is ``M^T`` times the
    raw one (block by block: the core is orthogonal)."""
    cfg, params = ref["cfg"], ref["params"]
    model = Model(cfg, "cpu")
    em = EmbeddingMorpher.create(3, d_in=cfg.frontend.d_in, kappa=4, d_out=None)
    raw = t_batch(ref["batch"])
    morphed = ProviderStage(embed_morpher=em, device="cpu")(raw)
    assert not torch.allclose(morphed["patches"], raw["patches"])
    fused = ParamTree(fuse_lm_params(params, cfg, embed_morpher=em))
    loss_raw, g_raw = grads_of(model, params, raw, remat=True)
    loss_mor, g_mor = grads_of(model, fused, morphed, remat=True)
    assert float(loss_mor) == pytest.approx(float(loss_raw), rel=LOSS_RTOL)
    for name, g in g_raw.items():
        if name != "frontend_proj":
            close_to(g_mor[name], g, GRAD_TOL, name)
    core = torch.from_numpy(em.core.matrix).double()
    q, d = em.core.q, cfg.d_model
    want = torch.matmul(core.T, g_raw["frontend_proj"].double().reshape(
        em.core.kappa, q, d)).reshape(-1, d)
    close_to(g_mor["frontend_proj"], want.numpy(), GRAD_TOL, "frontend_proj")


# -- the data pipeline --------------------------------------------------------

def test_frontend_stub_matches_reference_bytes():
    """``tests/test_data.py::test_frontend_stub_shapes``'s case on the
    port: the same bytes, shape and dtype as the reference's stub."""
    cfg = get_smoke_config(ARCH)
    d = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    jd = JDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    pipe, jpipe = Pipeline(d, model_cfg=cfg), JPipeline(jd, model_cfg=j_smoke(ARCH))
    for _ in range(2):
        got, want = next(pipe), next(jpipe)
        assert sorted(got) == sorted(want) == ["patches", "targets", "tokens"]
        assert got["patches"].shape == (2, cfg.frontend.n_tokens,
                                        cfg.frontend.d_in)
        assert got["patches"].dtype == want["patches"].dtype == np.float32
        assert got["patches"].tobytes() == want["patches"].tobytes()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_provider_stage_embedding_morph_matches_reference():
    """``--mole embedding`` (kappa 4): the port's provider stage morphs the
    patches through K4 (its plain version on the CPU) where the reference
    uses ``np.einsum``; tokens pass unmorphed.  Within MORPH_RTOL of
    max|x| of the reference and of a float64 product.  A model without a
    frontend refuses embedding mode, as the reference does."""
    mole = dict(enabled=True, mode="embedding", kappa=4, seed=5)
    cfg = dataclasses.replace(get_smoke_config(ARCH), mole=MoLeCfg(**mole))
    jcfg = dataclasses.replace(j_smoke(ARCH), mole=JMoLeCfg(**mole))
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    got = next(Pipeline(DataConfig(**kw), model_cfg=cfg, device="cpu"))
    want = next(JPipeline(JDataConfig(**kw), model_cfg=jcfg))
    assert isinstance(got["patches"], torch.Tensor)
    assert got["patches"].dtype == torch.float32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    x = next(Pipeline(DataConfig(**kw), model_cfg=get_smoke_config(ARCH)))
    x = x["patches"].astype(np.float64)
    core = EmbeddingMorpher.create(5, d_in=48, kappa=4).core.matrix
    exact = (x.reshape(2, -1, 4, 12) @ core.astype(np.float64)).reshape(x.shape)
    lim = MORPH_RTOL * np.abs(x).max()
    for other in (want["patches"], exact):
        np.testing.assert_allclose(got["patches"].numpy(), other, rtol=0,
                                   atol=lim)
    plain = dataclasses.replace(get_smoke_config("deepseek_7b"),
                                mole=MoLeCfg(**mole))
    with pytest.raises(ValueError, match="needs a frontend"):
        ProviderStage.for_model(plain, device="cpu")
    with pytest.raises(AssertionError, match="needs a frontend"):
        JPipeline(JDataConfig(**kw), model_cfg=dataclasses.replace(
            j_smoke("deepseek_7b"), mole=JMoLeCfg(**mole)))
