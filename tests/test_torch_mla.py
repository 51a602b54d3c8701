"""The port's multi-head latent attention (DeepSeek-V2's MLA) and the
``deepseek_v2_lite_16b`` model on the CPU against the JAX reference: one
``mla`` / ``mla_moe`` block in its full (prefill) and absorbed (decode)
forms, the whole smoke model (logits and its ``ckv`` / ``kr`` caches,
dense and through the flash scan at head_dim 24 with V padded from 16),
the loss and every gradient with one and two microbatches for both MoE
archs, the decode lane, and the launchers.

Inputs come from numpy with a seed; the reference's parameters carry over
with ``params_from_jax``.  Tolerances: ``RTOL`` 1e-5 relative with an
absolute floor of 1e-5 times the array's largest magnitude (one block; the
whole model within 1e-5 of max|logit| or four times the reference's own
departure from a float64 evaluation where that is larger,
``_lm_parity.hold_model``: at this config the reference departs from it
by 4.0e-6, so the bound stays 1e-5); the loss within ``LOSS_RTOL`` 1e-5 and
each gradient within ``GRAD_TOL`` 1e-4 of its leaf's max|reference|
(``tests/test_torch_train.py``'s bounds; ``GRAD_TOLS`` says why the
deepseek_moe_16b smoke config's are held at 5e-4).  Both smoke MoE configs route
2 of 8 experts; a call's capacity decides its drops, and both packages
route the same calls (a microbatch is one call).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.lm as jlm  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as jB, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve, steps, train  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Model, blocks as tB, params_from_jax, stack as tS,
)
from repro_torch.optim import adamw  # noqa: E402
from _lm_parity import close, hold_lane, hold_model  # noqa: E402

ARCH = "deepseek_v2_lite_16b"
FLASH = dict(dense_attn_max_seq=16, flash_block_kv=16)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
# At the deepseek_moe_16b smoke config the fp32 gradients are
# ill-conditioned: against the same model evaluated with float64 products
# (the port with dtype="float64"; norms, RoPE angles, attention scores and
# the router in fp32, as in both packages) the reference's own gradients
# depart by up to 1.9e-4 of a leaf's max|g| (the embedding's and the
# first norm's, with one and two microbatches) and the port's by 1.8e-4
# (deepseek_v2_lite_16b: 3.1e-5 and 2.4e-5).  Its gradients are held at
# 5e-4, a few times that departure.
GRAD_TOLS = {"deepseek_moe_16b": 5e-4}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke parameters (key 0) as numpy, shared by the
    block tests."""
    return jax.tree.map(np.asarray, JModel(j_smoke(ARCH)).init(jax.random.key(0)))


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["mla", "mla_moe"])
def test_block_full_and_decode_match_reference(rng, ref_params, kind,
                                               attention):
    """One block (the prefix ``mla`` layer with its dense FFN of 128, or a
    scanned ``mla_moe`` layer): a prefill of S positions writing ``ckv`` /
    ``kr`` (12 dense; 32 past ``dense_attn_max_seq`` 16, the flash scan at
    head_dim 24 with V padded from 16 to 24), then 3 decode steps in the
    absorbed form, against ``repro.models.stack.apply_block``: outputs and
    both caches at every step."""
    change = FLASH if attention == "flash" else {}
    cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
    jcfg = dataclasses.replace(j_smoke(ARCH), **change)
    jblock = (ref_params["prefix"][0] if kind == "mla"
              else jax.tree.map(lambda a: a[0], ref_params["blocks"]["b0"]))
    jblock = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jblock)     # non-zero norms
    one = dataclasses.replace(cfg, prefix_pattern=(), block_pattern=(kind,),
                              n_groups=1)
    tblock = params_from_jax(
        {"embed": ref_params["embed"],
         "blocks": {"b0": jax.tree.map(lambda a: a[None], jblock)}},
        one, device="cpu")["blocks"][0]
    if kind == "mla":   # the prefix layer's dense FFN is first_dense_ff wide
        assert tuple(tblock["ffn"]["wo"].shape) == (cfg.moe.first_dense_ff,
                                                    cfg.d_model)
    S, max_len = (32 if attention == "flash" else 12), 40
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(
        lambda a: a[0], JModel(jcfg).init_cache(2, max_len)["blocks"]["b0"])
    tcache = Model(cfg, "cpu").init_cache(2, max_len)["blocks"][1]
    tcache["ckv"].fill_(1.0)        # the prefill empties positions past S
    assert sorted(tcache) == ["ckv", "kr"]

    jfull = jax.jit(lambda p, x, c: jS.apply_block(
        p, x, jcfg, kind, jB.RunState(mode="full", write_cache=True), c))
    jdecode = jax.jit(lambda p, x, t, c: jS.apply_block(
        p, x, jcfg, kind, jB.RunState(mode="decode", t=t), c))
    jout, jcache = jfull(jblock, jnp.asarray(h), jcache)
    tout, tcache = tS.apply_block(
        tblock, _t(h), cfg, tB.RunState(mode="full", write_cache=True),
        tcache, kind)
    close(tout, jout)
    for name in ("ckv", "kr"):
        close(tcache[name], jcache[name])
    for t in range(S, S + 3):
        h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jdecode(jblock, jnp.asarray(h1), jnp.asarray(t), jcache)
        tout, tcache = tS.apply_block(
            tblock, _t(h1), cfg, tB.RunState(mode="decode", t=t), tcache,
            kind)
        close(tout, jout)
        for name in ("ckv", "kr"):
            close(tcache[name], jcache[name])


def test_per_row_positions_decode_each_row_at_its_own_t(rng):
    """A batched decode step with per-row positions (the decode lane's):
    each row writes its ``ckv`` / ``kr`` at its own t and attends to its
    own positions 0..t, equal to each row stepped alone."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    block = model.init(0)["blocks"][1]
    caches = model.init_cache(2, 16)["blocks"][1]
    h = _t(rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    tS.apply_block(block, h, cfg, tB.RunState(mode="full", write_cache=True),
                   caches, "mla_moe")
    for tt in range(7, 10):          # row 1 runs on to t = 10 alone
        x = _t(rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32))
        tS.apply_block(block, x, cfg, tB.RunState(mode="decode", t=tt),
                       {k: c[1:2] for k, c in caches.items()}, "mla_moe")
    alone = [{k: c[r : r + 1].clone() for k, c in caches.items()}
             for r in range(2)]
    t = torch.tensor([7, 10])
    x = _t(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    got, _ = tS.apply_block(block, x, cfg,
                            tB.RunState(mode="decode", t=t, row_calls=True),
                            caches, "mla_moe")
    for r in range(2):
        want, _ = tS.apply_block(
            block, x[r : r + 1], cfg,
            tB.RunState(mode="decode", t=int(t[r])), alone[r], "mla_moe")
        close(got[r : r + 1], want)
        for k in caches:
            close(caches[k][r], alone[r][k][0])
        assert not caches["ckv"][r, int(t[r]) + 1:].any()


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_model_prefill_and_decode_match_reference(rng, attention):
    """Forward, prefill and 8 decode steps of the smoke model against the
    reference (:func:`_lm_parity.hold_model`; the caches ``ckv`` / ``kr``
    after the last step too): 12 tokens dense, or 32 through the flash
    scan."""
    change = FLASH if attention == "flash" else {}
    cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
    jcfg = dataclasses.replace(j_smoke(ARCH), **change)
    S = 32 if attention == "flash" else 12
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    tc, _ = hold_model(cfg, jcfg, tokens, n_decode=8)
    assert all(sorted(c) == ["ckv", "kr"] for c in tc["blocks"])


def _leaves(tree, cfg) -> dict:
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return dict(adamw.named_leaves(params_from_jax(np_tree, cfg, "cpu")))


_VALUE_AND_GRAD = {}


def _value_and_grad(jcfg):
    """The reference's jitted loss and gradient (remat) of a microbatch of
    2 x 32 tokens, compiled once per config."""
    if jcfg not in _VALUE_AND_GRAD:
        jmodel = JModel(jcfg)
        _VALUE_AND_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss(p, b, remat=True)))
    return _VALUE_AND_GRAD[jcfg]


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", ARCH])
def test_loss_and_every_gradient_match_reference(rng, monkeypatch, arch,
                                                 micro):
    """``make_train_step`` on ``micro`` microbatches of 2 x 32 tokens (remat,
    the flash scan): the loss it reports and the gradients it hands
    AdamW against the mean of ``jax.value_and_grad`` of the reference's
    ``Model.loss`` over the same microbatches, each one routed as one call
    in both packages."""
    cfg = dataclasses.replace(get_smoke_config(arch), **FLASH)
    jcfg = dataclasses.replace(j_smoke(arch), **FLASH)
    jparams = JModel(jcfg).init(jax.random.key(4))
    batch = {k: rng.integers(0, cfg.vocab, (2 * micro, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    parts = [_value_and_grad(jcfg)(
        jparams, {k: jnp.asarray(v[2 * i:2 * i + 2]) for k, v in batch.items()})
        for i in range(micro)]
    want_loss = np.mean([float(lo) for lo, _ in parts])
    want = _leaves(jax.tree.map(lambda *g: sum(g) / micro,
                                *[g for _, g in parts]), cfg)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    seen = {}
    apply = adamw.apply

    def spy(cfg_, p, grads, state):
        seen.update(grads)
        return apply(cfg_, p, grads, state)

    monkeypatch.setattr(steps.adamw, "apply", spy)
    step = make_train_step(Model(cfg, "cpu"),
                           TrainHParams(microbatch=micro, remat=True))
    _, _, m = step(params, adamw.init_state(params),
                   {k: _t(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert sorted(seen) == sorted(want)
    for name, g in seen.items():
        w = want[name].double().numpy()
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(
            g.double().numpy(), w, rtol=0,
            atol=GRAD_TOLS.get(arch, GRAD_TOL) * np.abs(w).max(), err_msg=name)


def test_lane_matches_reference_lane():
    """The port's decode lane against the reference's on 3 rows, 6 tenants
    and 8 requests of 8 prompt tokens (rows retire and re-join, so a row's
    ``ckv`` / ``kr`` are re-admitted after another sequence), held token
    for token where the reference decides (``hold_lane``)."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    jparams = JModel(jcfg).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
               for _ in range(8)]
    gens = [3, 7, 4, 6, 2, 5, 7, 3]
    jreg = jlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=6)
    for i in range(6):
        jreg.register(f"t{i}", np_params["embed"], seed=60 + i,
                      head=np_params["head"])
    jlane = jrt.ContinuousDecodeLane(JModel(jcfg), jparams, jreg, rows=3,
                                     max_len=20)
    jsids = [jlane.submit(f"t{r % 6}", prompts[r], gens[r]) for r in range(8)]
    jlane.run()
    want = [np.asarray(jlane.take(s)) for s in jsids]
    reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=6)
    reg.restore_state(*jreg.snapshot_state())
    lane = trt.ContinuousDecodeLane(
        Model(cfg, "cpu"), params_from_jax(np_params, cfg, "cpu"), reg,
        rows=3, max_len=20, device="cpu")
    sids = [lane.submit(f"t{r % 6}", prompts[r], gens[r]) for r in range(8)]
    lane.run()
    got = [lane.take(s) for s in sids]
    assert hold_lane(jparams, jcfg, prompts, got, want) > 0


def test_readmitted_row_starts_clean():
    """A lane of one row: a sequence of 6 + 9 positions, then another
    admitted into the same row.  The second generation equals the same
    request in a fresh lane bit for bit: admission empties the row's
    ``ckv`` / ``kr``, so nothing of its predecessor is attended to."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    params = model.init(0)
    rng = np.random.default_rng(12)
    first = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    second = rng.integers(0, cfg.vocab, 4).astype(np.int32)

    def lane():
        reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=2)
        for i in range(2):
            reg.register(f"t{i}", params["embed"].numpy(), seed=i,
                         head=params["head"].numpy())
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


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", ARCH])
def test_launchers_serve_and_train_the_smoke_model(tmp_path, capsys, arch):
    """``serve --mode lm --smoke --device cpu`` (the lane, and
    ``--mole off``) and ``train --smoke --device cpu --steps 1`` run; the
    full config builds on the CPU without allocating (``Model``)."""
    from repro_torch.configs import get_config

    Model(get_config(arch), "cpu")
    flags = ["--mode", "lm", "--arch", arch, "--smoke", "--requests", "3",
             "--prompt-len", "8", "--gen", "3", "--device", "cpu"]
    for mole in ("token", "off"):
        out = tserve.main([*flags, "--mole", mole])
        assert np.asarray(out).shape == (3, 3)
    _, hist = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "1", "--seq-len", "16", "--batch", "2",
                          "--ckpt-dir", str(tmp_path)])
    losses = [float(h["loss"]) for h in hist if "loss" in h]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert f"arch={arch}" in capsys.readouterr().out
