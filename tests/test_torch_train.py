"""The port's train step of the attention LMs on the CPU against the JAX
reference: the loss (``models/api.py`` ``cross_entropy``, ``Model.loss``,
``models/stack.py`` ``fused_ce``) and every leaf's gradient, AdamW
(``optim/adamw.py``), ``launch/steps.py`` ``make_train_step`` with
microbatching and remat, and the provider stage (``data/pipeline.py``
``ProviderStage``, ``Pipeline``).

Inputs come from numpy with a seed; weights carry over with
``params_from_jax`` (the reference's stacked block leaves, its gradients
and its moments alike).  Tolerances:

  * losses: ``LOSS_RTOL`` 1e-5, the reference's own bound for equal losses
    (``tests/test_mole_lm.py``); the port and the reference agree to 1.5e-7
    at the smoke configs;
  * gradients, leaf by leaf: ``GRAD_TOL`` 1e-4 of the leaf's
    max|reference|.  Each package's fp32 gradient lies up to 4.3e-5 of that
    max from a float64 run of the port at the deepseek_7b smoke config
    (softmax-CE and attention gradients cancel), so two fp32 runs may
    differ by twice that;
  * AdamW on given gradients: ``ADAM_RTOL`` 1e-6 of max|reference| (the
    same fp32 expressions; ``pow``/``cos``/``sqrt`` may differ by an ulp);
  * the train step's parameters: see :func:`_hold_update`.

The smoke configs run dense attention at S <= 1024; ``FLASH`` lowers
``dense_attn_max_seq`` and ``flash_block_kv`` to 16 on both packages so
that S = 64 runs the flash scan (4 Q blocks by 4 KV blocks) and its
backward.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core.deploy import fuse_lm_params as j_fuse_lm_params  # noqa: E402
from repro.core.lm import TokenMorpher as JTokenMorpher  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.launch.steps import TrainHParams as JTrainHParams  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.models.api import cross_entropy as j_cross_entropy  # noqa: E402
from repro.models.base import MoLeCfg as JMoLeCfg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.deploy import fuse_lm_params  # noqa: E402
from repro_torch.core.lm import TokenMorpher, fuse_aug_head  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig, Pipeline, ProviderStage, SyntheticLM,
)
from repro_torch.kernels import wkv6_chunked  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainHParams, make_batched_decode_step, make_row_prefill_step,
    make_train_step,
)
from repro_torch.models import (  # noqa: E402
    Model, ParamTree, params_from_jax, stack as tS,
)
from repro_torch.models.api import cross_entropy  # noqa: E402
from repro_torch.models.base import MoLeCfg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# The gemma2_27b smoke config is ill-conditioned in fp32 (post-norms over
# small sublayer outputs, soft-caps, tied and scaled embeddings): against
# the same model evaluated with float64 products (the port with
# dtype="float64", norms, RoPE angles and attention scores in fp32 as in
# both packages), the reference's own gradients depart by up to 6.0e-4 of
# max|g| and its grad_norm by 2.8e-4 relative, the port's by 7.3e-4 and
# 3.9e-4 (deepseek_7b: 4.6e-5 and 1.3e-5 for the reference, 6.0e-5 and
# 1.1e-5 for the port; command_r_35b below 2e-5 and 4e-6).  Its gradients
# and moments are held at GRAD_TOLS, its grad_norm at NORM_RTOLS, a few
# times those departures; every other arch at GRAD_TOL and LOSS_RTOL.
# The recurrentgemma_2b smoke hybrid (RG-LRU and local layers, tied and
# scaled embeddings), against the port run with every op in float64 (its
# RG-LRU gates and scan too, which both packages run in fp32), on these
# tests' inputs: the reference's gradients depart by up to 2.4e-4 of
# max|g| and its grad_norm by 3.1e-5 relative, the port's by 3.9e-4 and
# 9.0e-5 (the port's local layers alone depart twice as far as the
# reference's in grad_norm; its rec layers alone by 1e-6 of max|g|, as
# the reference's).  Held at about four times the reference's departures.
# The rwkv6_3b smoke stack, against the port in float64 on these tests'
# inputs: the reference's gradients depart by up to 2.5e-5 of max|g| and
# the port's by 3.4e-5 (both at blocks.0.mix.w0), held at about four times
# that.  Its zero-initialised maa_x leaves have max|g| of 6.6e-5 at the
# first step, so AdamW's eps moves g / (|g| + eps) of their decided
# entries by more than 1e-6; the bound above GRAD_TOL counts that
# (:func:`_hold_update`).
GRAD_TOLS = {"gemma2_27b": 2e-3, "recurrentgemma_2b": 1e-3,
             "rwkv6_3b": 1.4e-4}
NORM_RTOLS = {"gemma2_27b": 2e-3, "recurrentgemma_2b": 1.2e-4}
ADAM_RTOL = 1e-6
ARCHS = ["deepseek_7b", "phi3_mini_3p8b", "command_r_35b", "gemma2_27b",
         "recurrentgemma_2b", "rwkv6_3b"]
FLASH = dict(dense_attn_max_seq=16, flash_block_kv=16)
ATTENTION = {"dense": {}, "flash": FLASH}
S = 64


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _batch(rng, vocab, B=2, S=S):
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaves(tree, cfg) -> dict:
    """A reference tree (params, gradients or moments) as the port's
    ``{dotted name: tensor}``."""
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return dict(adamw.named_leaves(params_from_jax(np_tree, cfg, "cpu")))


def _close(got, want, tol, what=""):
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(torch.as_tensor(want).detach().double())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _grads(model, params, batch, remat):
    names, leaves = zip(*adamw.named_leaves(params))
    with steps._grad_on(leaves):
        loss = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


# -- the loss -------------------------------------------------------------------

def test_cross_entropy_matches_reference(rng):
    logits = (rng.standard_normal((2, 7, 97)) * 3).astype(np.float32)
    targets = rng.integers(0, 97, (2, 7)).astype(np.int32)
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("S_,chunk", [(1024, 512), (600, 512), (64, 16),
                                      (60, 16)])
def test_fused_ce_matches_reference_and_unfused(rng, S_, chunk):
    """Chunks of 512 over 1024 positions and of 16 over 64, and one chunk
    where the chunk does not divide S (600, 60); the reference's
    ``fused_ce`` with the same chunk, and the port's ``cross_entropy`` of
    the full logits."""
    jcfg, cfg = _cfgs("deepseek_7b")
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    h = (rng.standard_normal((2, S_, cfg.d_model)) * 0.5).astype(np.float32)
    targets = rng.integers(0, cfg.vocab, (2, S_)).astype(np.int32)
    want = float(jS.fused_ce(jparams, jcfg, jnp.asarray(h),
                             jnp.asarray(targets), chunk=chunk))
    th, tt = torch.from_numpy(h), torch.from_numpy(targets)
    got = float(tS.fused_ce(params, cfg, th, tt, chunk=chunk))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    unfused = cross_entropy(torch.matmul(th, params["head"]), tt)
    assert got == pytest.approx(float(unfused), rel=LOSS_RTOL)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("attention", sorted(ATTENTION))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(rng, arch, attention, remat):
    """``Model.loss`` and each leaf's gradient against ``jax.grad`` of the
    reference's ``Model.loss``, both with the same ``remat``."""
    jcfg, cfg = _cfgs(arch, **ATTENTION[attention])
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = _batch(rng, cfg.vocab)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=remat)
    ))(jparams, _j(batch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    loss, grads = _grads(Model(cfg, "cpu"), params, _t(batch), remat)
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = _leaves(want_g, cfg)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        _close(g, want[name], GRAD_TOLS.get(arch, GRAD_TOL), name)
    assert not any(p.requires_grad for p in params.parameters())


def test_unfused_loss_and_logits_match_reference(rng):
    """``fused_ce=False``: ``cross_entropy`` of ``Model.logits``, and its
    gradients, through the flash scan with remat."""
    jcfg, cfg = _cfgs("deepseek_7b", fused_ce=False, **FLASH)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    batch = _batch(rng, cfg.vocab)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=True)
    ))(jparams, _j(batch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    model = Model(cfg, "cpu")
    loss, grads = _grads(model, params, _t(batch), remat=True)
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want = _leaves(want_g, cfg)
    for name, g in grads.items():
        _close(g, want[name], GRAD_TOL, name)
    # the model logits' bound of tests/test_torch_flash.py (LONG_RTOL): the
    # two scans sum each softmax in other orders (1.0e-5 of max seen here)
    _close(model.logits(params, _t(batch)),
           jmodel.logits(jparams, _j(batch)), 1e-4)


@pytest.mark.parametrize("arch", ["deepseek_7b", "phi3_mini_3p8b", "rwkv6_3b",
                                  "command_r_35b", "gemma2_27b",
                                  "whisper_tiny"])
def test_param_count_matches_reference(arch):
    """Counted from the schema at the smoke and the FULL configs (nothing
    allocated: 6.91 B parameters at deepseek_7b)."""
    from repro.configs import get_config as j_get_config
    assert Model(get_smoke_config(arch), "cpu").param_count() == \
        JModel(j_smoke(arch)).param_count()
    assert Model(get_config(arch), "cpu").param_count() == \
        JModel(j_get_config(arch)).param_count()


# -- AdamW ----------------------------------------------------------------------

def test_adamw_first_step_matches_closed_form(rng):
    """``tests/test_optim.py``: after bias correction at t = 1 the step is
    g / (|g| + eps)."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0,
                            clip_norm=1e9)
    w = rng.standard_normal((4,)).astype(np.float32)
    gw = rng.standard_normal((4,)).astype(np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    st = adamw.init_state(p)
    p2, st2, _ = adamw.apply(cfg, p, {"w": torch.from_numpy(gw)}, st)
    expect = w - 1e-2 * gw / (np.abs(gw) + cfg.eps)
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-4)
    assert int(st2["count"]) == 1


def test_adamw_clipping_reports_the_norm():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, clip_norm=1.0,
                            weight_decay=0.0)
    p = {"w": torch.zeros(3)}
    _, _, metrics = adamw.apply(cfg, p, {"w": torch.tensor([100.0, 0.0, 0.0])},
                                adamw.init_state(p))
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_lr_schedule_shape_and_values():
    """``tests/test_optim.py``'s shape, and every step of the schedule
    against the reference's ``lr_at``."""
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                            min_lr_ratio=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                              min_lr_ratio=0.1)
    lrs = [float(adamw.lr_at(cfg, s)) for s in (0, 5, 10, 55, 100, 1000)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1.0, abs=0.1)
    assert lrs[3] > lrs[4]
    assert lrs[-1] == pytest.approx(0.1, abs=1e-3)
    for s in range(0, 120):
        assert float(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jadamw.lr_at(jcfg, jnp.asarray(s))),
                          rel=ADAM_RTOL)


@pytest.mark.parametrize("clip_norm", [1e9, 0.5], ids=["unclipped", "clipped"])
def test_adamw_apply_matches_reference(rng, clip_norm):
    """Three ``apply`` calls on one tree (fp32 and bf16 leaves, decay on)
    against the reference: params, moments, count, grad_norm and lr."""
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10, clip_norm=clip_norm)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    shapes = {"a": (5, 3), "b": (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tp = {"a": torch.from_numpy(p["a"].copy()),
          "b": torch.from_numpy(p["b"]).to(torch.bfloat16)}
    jp = {"a": jnp.asarray(p["a"]), "b": jnp.asarray(p["b"], jnp.bfloat16)}
    st, jst = adamw.init_state(tp), jadamw.init_state(jp)
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        tp, st, m = adamw.apply(cfg, tp, {k: torch.from_numpy(v)
                                          for k, v in g.items()}, st)
        jp, jst, jm = jadamw.apply(jcfg, jp, {k: jnp.asarray(v)
                                               for k, v in g.items()}, jst)
        assert int(st["count"]) == int(jst["count"])
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=ADAM_RTOL)
        for k in shapes:
            _close(st["m"][k], jst["m"][k], ADAM_RTOL, k)
            _close(st["v"][k], jst["v"][k], ADAM_RTOL, k)
        _close(tp["a"], jp["a"], ADAM_RTOL)
        # bf16 leaf: the fp32 result rounded once on each side
        assert tp["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp["b"].float().numpy(), np.asarray(jp["b"], np.float32))


def test_adamw_slices_give_the_whole_leaf_bits(rng, monkeypatch):
    """``adamw.apply`` updates a leaf larger than ``adamw.SLICE`` in flat
    slices (so its fp32 temporaries stay small): over 3 steps the
    parameters and moments are bit for bit those of whole-leaf updates,
    for fp32, bf16 and 0-d leaves and a non-contiguous gradient."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=10)
    shapes = {"a": (5, 3), "b": (17,), "c": ()}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    def run(slice_):
        monkeypatch.setattr(adamw, "SLICE", slice_)
        p = {"a": torch.from_numpy(init["a"].copy()),
             "b": torch.from_numpy(init["b"]).to(torch.bfloat16),
             "c": torch.from_numpy(init["c"].copy())}
        st = adamw.init_state(p)
        for g in grads:
            tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
            tg["a"] = tg["a"].T.contiguous().T      # not contiguous
            p, st, _ = adamw.apply(cfg, p, tg, st)
        return p, st

    whole, sliced = run(1 << 26), run(4)
    for k in shapes:
        assert torch.equal(whole[0][k], sliced[0][k]), k
        for mom in ("m", "v"):
            assert torch.equal(whole[1][mom][k], sliced[1][mom][k]), (mom, k)


# -- the train step ---------------------------------------------------------------

def _hold_update(name, got, want, before, grad, lr, grad_tol=GRAD_TOL,
                 scale=1.0):
    """One Adam step's parameters against the reference's.  At t = 1 the
    step is lr * (g s / (|g s| + eps) + wd p): ±lr wherever |g| >> eps.  A
    gradient entry near zero may take the other sign in the other package
    (the gradients agree to ``GRAD_TOL`` of their max), which moves that
    entry by up to 2 lr; where |g_ref| >= 1e-2 max|g_ref| the sign is
    decided and g/(|g| + eps) agrees to 1e-6, so the parameters agree to
    1e-6 of max|p| + lr (fp32 rounding of p and of the step).  Gradients
    held at a ``grad_tol`` above GRAD_TOL, d = grad_tol max|g| apart and
    clipped by ``scale`` (s), move g s/(|g s| + eps) by up to
    eps d / (s |g| (|g| - d)) more, which is added entry by entry.
    Everywhere within 2 lr + that."""
    got, want, before, grad = (np.asarray(x, np.float64) for x in
                               (got, want, before, grad))
    diff = np.abs(got - want)
    slack = np.full(diff.shape, 1e-6 * (np.abs(before).max() + lr))
    decided = np.abs(grad) >= 1e-2 * np.abs(grad).max()
    if grad_tol > GRAD_TOL:
        d, g = grad_tol * np.abs(grad).max(), np.abs(grad[decided])
        slack[decided] += (lr * adamw.AdamWConfig().eps * d
                           / (scale * g * (g - d)))
    assert (diff[decided] <= slack[decided]).all(), (name, diff[decided].max())
    assert (diff <= 2 * lr + slack).all(), (name, diff.max())


@pytest.mark.parametrize("microbatch", [None, 2], ids=["one_shot", "micro2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(rng, arch, microbatch):
    """``make_train_step`` against the reference's jitted step, through the
    flash scan with remat: loss, grad_norm, lr, count, both moments and the
    parameters (:func:`_hold_update`)."""
    jcfg, cfg = _cfgs(arch, **FLASH)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    hp_kw = dict(microbatch=microbatch, remat=True)
    opt = adamw.AdamWConfig(warmup_steps=2)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainHParams(
        optimizer=jadamw.AdamWConfig(warmup_steps=2), **hp_kw)))
    step = make_train_step(Model(cfg, "cpu"), TrainHParams(optimizer=opt, **hp_kw))
    batch = _batch(rng, cfg.vocab, B=4)
    _, want_g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, _j(batch))))(jparams)
    want_p, want_opt, want_m = jstep(jparams, jadamw.init_state(jparams),
                                     _j(batch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    before = {n: p.detach().clone() for n, p in adamw.named_leaves(params)}
    out, opt_state, m = step(params, adamw.init_state(params), _t(batch))
    assert out is params
    assert int(opt_state["count"]) == int(want_opt["count"]) == 1
    rtols = {"grad_norm": NORM_RTOLS.get(arch, LOSS_RTOL)}
    for k in ("loss", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(want_m[k]),
                                            rel=rtols.get(k, LOSS_RTOL)), k
    grads = _leaves(want_g, cfg)
    grad_tol = GRAD_TOLS.get(arch, GRAD_TOL)
    for key, tol in (("m", grad_tol), ("v", 2 * grad_tol)):
        want = _leaves(want_opt[key], cfg)
        for name, got in opt_state[key].items():
            _close(got, want[name], tol, f"{key} {name}")
    want = _leaves(want_p, cfg)
    lr = float(want_m["lr"])
    clip = min(1.0, opt.clip_norm / float(want_m["grad_norm"]))
    for name, p in adamw.named_leaves(params):
        assert not p.requires_grad
        _hold_update(name, p.detach(), want[name], before[name], grads[name],
                     lr, grad_tol, clip)


def test_microbatch_gradients_sum_in_fp32(rng, monkeypatch):
    """bf16 parameters, 2 microbatches: AdamW receives the fp32 sum of the
    two microbatches' bf16 gradients over 2 (the reference's scan), not a
    bf16 accumulation, which differs from it on this batch."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(3)
    batch = _t(_batch(rng, cfg.vocab, B=4))
    micro = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in (0, 1)]
    per = [_grads(model, params, mb, remat=True) for mb in micro]
    seen = {}
    apply = adamw.apply

    def spy(cfg_, p, grads, state):
        seen.update(grads)
        return apply(cfg_, p, grads, state)

    monkeypatch.setattr(steps.adamw, "apply", spy)
    step = make_train_step(model, TrainHParams(microbatch=2))
    _, _, m = step(params, adamw.init_state(params), batch)
    assert float(m["loss"]) == pytest.approx(
        (float(per[0][0]) + float(per[1][0])) / 2, rel=LOSS_RTOL)
    bf16_differs = False
    for name, g in seen.items():
        g0, g1 = per[0][1][name], per[1][1][name]
        assert g0.dtype == torch.bfloat16 and g.dtype == torch.float32
        assert torch.equal(g, (g0.float() + g1.float()) / 2), name
        bf16_differs |= not torch.equal(g, (g0 + g1).float() / 2)
    assert bf16_differs


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(rng, arch):
    """``tests/test_models_smoke.py::test_one_train_step`` on the port."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu")
    params = model.init(1)
    before = [p.detach().clone() for p in params.parameters()]
    step = make_train_step(model, TrainHParams(microbatch=2))
    _, opt, metrics = step(params, adamw.init_state(params),
                           _t(_batch(rng, cfg.vocab, B=4, S=16)))
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert int(opt["count"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, params.parameters()))


def test_training_reduces_loss_on_learnable_data():
    """``tests/test_optim.py::test_training_reduces_loss_on_learnable_data``
    on the port: 30 steps on the synthetic grammar."""
    cfg = get_smoke_config("deepseek_7b")
    model = Model(cfg, "cpu")
    params = model.init(0)
    opt = adamw.init_state(params)
    hp = TrainHParams(optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                  decay_steps=60))
    step = make_train_step(model, hp)
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                               seed=0), model_cfg=cfg)
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, _t(next(pipe)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]


def test_rwkv_train_step_raises():
    """RWKV-6 trains: ``make_train_step`` builds for the smoke stack and
    lowers its loss on the synthetic grammar over 12 steps (2
    microbatches, remat), the scan's gradient through ``wkv6_scan``; what
    still raises is K6's own wrapper, handed an operand that requires grad
    (it has no backward of its own)."""
    cfg = get_smoke_config("rwkv6_3b")
    model = Model(cfg, "cpu")
    params = model.init(0)
    opt = adamw.init_state(params)
    step = make_train_step(model, TrainHParams(
        optimizer=adamw.AdamWConfig(lr=3e-3, warmup_steps=3, decay_steps=24),
        microbatch=2))
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                               seed=0), model_cfg=cfg)
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, _t(next(pipe)))
        assert torch.isfinite(m["grad_norm"])
        losses.append(float(m["loss"]))
    assert int(opt["count"]) == 12
    assert losses[-1] < losses[0] - 0.3, losses[::3]
    assert not any(p.requires_grad for p in params.parameters())
    r = torch.zeros(2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        wkv6_chunked(r, r.detach(), r.detach(), r.detach(),
                     torch.zeros(2, 16), torch.zeros(2, 16, 16), chunk=4)


# -- MoLe in training ---------------------------------------------------------------

def test_aug_head_losses_match(rng):
    """``tests/test_mole_lm.py::test_aug_head_losses_match`` on the port."""
    tm = TokenMorpher.create(1, 97)
    head = torch.from_numpy(rng.standard_normal((8, 97)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((5, 1, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 97, (5, 1)))
    assert float(cross_entropy(h @ head, labels)) == pytest.approx(
        float(cross_entropy(h @ fuse_aug_head(head, tm),
                            tm.morph_tokens(labels))), rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["deepseek_7b", "rwkv6_3b", "command_r_35b",
                                  "gemma2_27b", "recurrentgemma_2b"])
def test_token_mole_loss_equivalence(rng, arch):
    """loss(params, raw) == loss(fused params, morphed) and both equal the
    reference's loss (no grad: the rwkv loss runs K6's plain version)."""
    jcfg, cfg = _cfgs(arch)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    batch = _batch(rng, cfg.vocab, S=16)
    tm = TokenMorpher.create(7, cfg.vocab)
    morphed = {k: tm.perm[v] for k, v in batch.items()}
    want = float(jmodel.loss(j_fuse_lm_params(
        jparams, jcfg, token_morpher=JTokenMorpher.create(7, jcfg.vocab)), _j(morphed)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    fused = ParamTree(fuse_lm_params(params, cfg, token_morpher=tm))
    model = Model(cfg, "cpu")
    raw = float(model.loss(params, _t(batch)))
    assert float(model.loss(fused, _t(morphed))) == pytest.approx(raw, rel=LOSS_RTOL)
    assert raw == pytest.approx(want, rel=LOSS_RTOL)


def test_token_mole_training_equivalence():
    """Three train steps of the raw params on the raw stream against the
    fused params on the morphed stream (``Pipeline`` with the provider
    stage), from one init, through the flash scan: the losses agree to
    ``LOSS_RTOL`` at every step (measured here: equal at steps 1 and 2,
    7.6e-8 apart at step 3; 1.5e-6 with the config in bf16)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), **FLASH)
    mcfg = dataclasses.replace(cfg, mole=MoLeCfg(enabled=True, mode="token",
                                                 seed=5))
    model = Model(cfg, "cpu")
    step = make_train_step(model, TrainHParams(
        optimizer=adamw.AdamWConfig(warmup_steps=2), microbatch=2))
    data = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=4, seed=0)

    def run(params, pipe):
        opt, losses = adamw.init_state(params), []
        for _ in range(3):
            params, opt, m = step(params, opt, _t(next(pipe)))
            losses.append(float(m["loss"]))
        return losses

    raw = run(model.init(0), Pipeline(data, model_cfg=cfg))
    fused = ParamTree(fuse_lm_params(
        model.init(0), cfg, token_morpher=TokenMorpher.create(5, cfg.vocab)))
    morphed = run(fused, Pipeline(data, model_cfg=mcfg))
    np.testing.assert_allclose(morphed, raw, rtol=LOSS_RTOL)


# -- serving after training -----------------------------------------------------------

def _serve_outputs(model, params):
    """One admission prefill and one batched decode step of the decode
    lane's step builders, on the model's own head and embedding."""
    cfg = model.cfg
    embed, head = params["embed"].detach(), params["head"].detach()
    tokens = torch.arange(6, dtype=torch.int32)[None] % cfg.vocab
    caches = model.init_cache(1, 8)
    first, caches = make_row_prefill_step(model)(params, embed, head, tokens,
                                                 caches)
    nxt, caches = make_batched_decode_step(model)(
        params, embed[None], head[None], torch.zeros(1, dtype=torch.int32),
        first, torch.tensor([6]), caches)
    return [first, nxt] + [c[k] for c in caches["blocks"] for k in ("k", "v")]


def test_training_leaves_serving_without_a_graph(rng):
    """Before and after a train step (and after one that fails midway) the
    parameters do not require grad, and the serving steps' outputs and
    caches carry no ``grad_fn``."""
    cfg = get_smoke_config("deepseek_7b")
    model = Model(cfg, "cpu")
    params = model.init(0)
    for out in _serve_outputs(model, params):
        assert out.grad_fn is None and not out.requires_grad
    step = make_train_step(model, TrainHParams(microbatch=2))
    opt = adamw.init_state(params)
    params, opt, _ = step(params, opt, _t(_batch(rng, cfg.vocab, B=4, S=8)))
    with pytest.raises(AssertionError):       # 3 rows in 2 microbatches
        step(params, opt, _t(_batch(rng, cfg.vocab, B=3, S=8)))
    assert not any(p.requires_grad for p in params.parameters())
    for out in _serve_outputs(model, params):
        assert out.grad_fn is None and not out.requires_grad
    with torch.enable_grad():
        logits = model.decode(params, torch.zeros(1, 1, dtype=torch.int64), 0,
                              model.init_cache(1, 4))[0]
    assert logits.grad_fn is None


# -- the provider stage ---------------------------------------------------------------

def test_provider_stage_morphs_tokens_as_the_reference():
    """``tests/test_mole_lm.py``'s provider test, and the morphed batches
    equal to the reference ``Pipeline``'s."""
    jcfg = dataclasses.replace(j_smoke("deepseek_7b"),
                               mole=JMoLeCfg(enabled=True, mode="token", seed=5))
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"),
                              mole=MoLeCfg(enabled=True, mode="token", seed=5))
    d = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    raw = Pipeline(d, model_cfg=dataclasses.replace(cfg, mole=MoLeCfg()))
    sec = Pipeline(d, model_cfg=cfg)
    want = JPipeline(JDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                 seed=0), model_cfg=jcfg)
    for _ in range(3):
        b_raw, b_sec, b_want = next(raw), next(sec), next(want)
        tm = TokenMorpher.create(5, cfg.vocab)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(b_sec[k], tm.perm[b_raw[k]])
            np.testing.assert_array_equal(b_sec[k], b_want[k])
            assert b_sec[k].dtype == b_want[k].dtype
        assert not np.array_equal(b_sec["tokens"], b_raw["tokens"])
    assert ProviderStage.for_model(dataclasses.replace(cfg, mole=MoLeCfg())) \
        .token_morpher is None


def test_pipeline_determinism_seek_and_state():
    cfg = get_smoke_config("deepseek_7b")
    d = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    p1 = Pipeline(d, model_cfg=cfg)
    batches = [next(p1) for _ in range(5)]
    assert p1.state() == {"index": 5}
    p2 = Pipeline(d, model_cfg=cfg)
    p2.seek(3)
    np.testing.assert_array_equal(next(p2)["tokens"], batches[3]["tokens"])
    assert p2.state() == {"index": 4}
    p3 = Pipeline(d, model_cfg=cfg, start_index=1)
    np.testing.assert_array_equal(next(iter(p3))["targets"], batches[1]["targets"])


def test_pipeline_refuses_what_the_port_does_not_run():
    """Embedding-mode MoLe on a model without a frontend is refused, as the
    reference refuses it (an assertion there); a config of a later slice
    raises ``NotImplementedError``."""
    cfg = get_smoke_config("deepseek_7b")
    d = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    with pytest.raises(ValueError, match="needs a frontend"):
        Pipeline(d, model_cfg=dataclasses.replace(
            cfg, mole=MoLeCfg(enabled=True, mode="embedding")), device="cpu")
    with pytest.raises(AssertionError, match="needs a frontend"):
        JPipeline(JDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
                  model_cfg=dataclasses.replace(
                      j_smoke("deepseek_7b"),
                      mole=JMoLeCfg(enabled=True, mode="embedding")))
    with pytest.raises(NotImplementedError):
        Pipeline(d, model_cfg=dataclasses.replace(cfg,
                                                  block_pattern=("attn_moe",)))


def test_zipf_unigram_statistics():
    """``tests/test_data.py`` on the port's source."""
    src = SyntheticLM(DataConfig(vocab=256, seq_len=512, global_batch=16, seed=0))
    toks = np.concatenate([src.batch(i)["tokens"].ravel() for i in range(4)])
    top = np.sort(np.bincount(toks, minlength=256))[::-1]
    assert top[0] > 4 * top[20]


def test_grammar_makes_targets_predictable():
    src = SyntheticLM(DataConfig(vocab=128, seq_len=256, global_batch=8, seed=1,
                                 grammar_strength=0.7))
    b = src.batch(0)
    assert 0.6 < (src.successor[b["tokens"]] == b["targets"]).mean() < 0.8


def test_batches_are_pure_functions_of_index():
    cfg = DataConfig(vocab=64, seq_len=32, global_batch=4, seed=2)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    for i in (0, 5, 17):
        np.testing.assert_array_equal(a.batch(i)["tokens"], b.batch(i)["tokens"])
    assert not np.array_equal(a.batch(0)["tokens"], a.batch(1)["tokens"])


def test_targets_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab=64, seq_len=32, global_batch=2, seed=3)).batch(0)
    assert b["tokens"].shape == b["targets"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
