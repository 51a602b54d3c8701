"""The port's model layers and stack (``repro_torch.models``) on the CPU
against the JAX reference (``repro.models``) at the ``deepseek_7b`` smoke
config (2 layers, d 64, vocab 512, fp32).

Inputs come from numpy with a seed; the reference's parameters carry over
with ``params_from_jax``.  Tolerance: rtol 1e-5 in fp32 (the two frameworks
sum in other orders), with an absolute floor of 1e-5 times the array's
largest magnitude for entries near zero (cancellation leaves them with the
absolute, not the relative, error of their neighbours).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as jB, layers as jL, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step,
)
from repro_torch.models import (  # noqa: E402
    Model, blocks as tB, layers as tL, params_from_jax, stack as tS,
)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        rtol=rtol, atol=rtol * float(np.abs(want).max()),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jparams(cfg, seed=0):
    params = JModel(cfg).init(jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def test_rms_norm_layer_norm_softcap(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(tL.rms_norm(_t(x), _t(w)), jL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tL.layer_norm(_t(x), _t(w)),
           jL.layer_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tL.softcap(_t(x), 2.0), jL.softcap(jnp.asarray(x), 2.0))


def test_rope(rng):
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7))
    _close(tL.rope(_t(x), _t(pos), 10_000.0),
           jL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("hq,hkv,cap", [(4, 4, None), (4, 2, 5.0)])
def test_dense_attention(rng, hq, hkv, cap):
    q = rng.standard_normal((2, 6, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 6, hkv, 16)).astype(np.float32)
    _close(
        tL.dense_attention(_t(q), _t(k), _t(v), logit_cap=cap),
        jL.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           logit_cap=cap),
    )


def test_decode_attention(rng):
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    _close(tL.decode_attention(_t(q), _t(kc), _t(vc), 6),
           jL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(6)))


def test_gated_mlp(rng):
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 160)).astype(np.float32) * 0.1
              for _ in range(2))
    wo = rng.standard_normal((160, 64)).astype(np.float32) * 0.1
    for act in ("swiglu", "geglu"):
        _close(tL.gated_mlp(_t(x), _t(wg), _t(wu), _t(wo), act),
               jL.gated_mlp(*map(jnp.asarray, (x, wg, wu, wo)), act))


def test_attention_above_dense_limit_is_flash(rng):
    """Above ``dense_max_seq ** 2`` score entries the dispatch computes the
    reference's chunked ``flash_attention`` (block_q 16, block_kv 8 here).
    The flash scan's own cases are in ``test_torch_flash.py``."""
    q, k, v = (rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    _close(tL.attention(_t(q), _t(k), _t(v), dense_max_seq=8, block_kv=8),
           jL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_kv=8))


@pytest.mark.parametrize("variant", [
    {}, {"qkv_bias": True, "attn_softcap": 20.0, "attn_scale": 0.3},
    {"parallel_block": True}, {"post_norm": True, "norm": "layernorm"},
    {"act": "gelu"},
])
def test_attention_block_full_and_decode(rng, variant):
    """One block, prefill (writing its cache) then a decode step, against
    ``repro.models.stack.apply_block``."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), **variant)
    jcfg = dataclasses.replace(j_smoke("deepseek_7b"), **variant)
    _, jp = _jparams(jcfg)
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"]["b0"])
    jblock = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jblock,
    )   # non-zero norms and biases
    tblock = params_from_jax(
        {"embed": jp["embed"], "blocks": {"b0": jax.tree.map(
            lambda a: a[None], jblock)}},
        dataclasses.replace(cfg, n_groups=1), device="cpu",
    )["blocks"][0]
    S, max_len = 5, 8
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jcache = JModel(jcfg).init_cache(2, max_len)
    jcache = jax.tree.map(lambda a: a[0], jcache["blocks"]["b0"])
    tcache = Model(cfg, "cpu").init_cache(2, max_len)["blocks"][0]

    jout, jcache = jS.apply_block(
        jblock, jnp.asarray(h), jcfg, "attn",
        jB.RunState(mode="full", write_cache=True), jcache,
    )
    tout, tcache = tS.apply_block(
        tblock, _t(h), cfg, tB.RunState(mode="full", write_cache=True), tcache,
    )
    _close(tout, jout)
    _close(tcache["k"], jcache["k"])

    h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jcache = jS.apply_block(
        jblock, jnp.asarray(h1), jcfg, "attn",
        jB.RunState(mode="decode", t=jnp.asarray(S)), jcache,
    )
    tout, _ = tS.apply_block(
        tblock, _t(h1), cfg, tB.RunState(mode="decode", t=S), tcache,
    )
    _close(tout, jout)


def test_forward_and_decode_logits_match_reference(rng):
    """Prefill then three greedy decode steps: logits within rtol 1e-5 of
    ``repro.models.stack`` / ``repro.models.api.Model`` at every step, and
    the same greedy tokens."""
    cfg, jcfg = get_smoke_config("deepseek_7b"), j_smoke("deepseek_7b")
    jparams, jp = _jparams(jcfg)
    tparams = params_from_jax(jp, cfg, device="cpu")
    jm, tm = JModel(jcfg), Model(cfg, "cpu")
    tokens = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)

    jl, _ = jS.forward(jparams, jcfg, jnp.asarray(tokens))
    tl_, _ = tS.forward(tparams, cfg, _t(tokens))
    _close(tl_, jl)

    # The port's side through the per-tenant serving steps.
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    jlog, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 12)
    tlog, tc = prefill(tparams, {"tokens": _t(tokens)}, tm.init_cache(2, 12))
    _close(tlog, jlog)
    for i in range(3):
        jtok = jnp.argmax(jlog[:, 0], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlog[:, 0], -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jc = jm.decode(jparams, jtok, jnp.asarray(6 + i), jc)
        tlog, tc = decode(tparams, ttok, 6 + i, tc)
        _close(tlog, jlog)


def test_model_init_draws_reference_shapes():
    cfg = get_smoke_config("deepseek_7b")
    tp = Model(cfg, "cpu").init(0)
    _, jp = _jparams(j_smoke("deepseek_7b"))
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    assert tuple(tp["head"].shape) == jp["head"].shape
    assert len(tp["blocks"]) == cfg.n_groups
    wq = tp["blocks"][1]["mix"]["wq"]
    assert tuple(wq.shape) == jp["blocks"]["b0"]["mix"]["wq"].shape[1:]
    assert not wq.requires_grad
    assert float(tp["blocks"][0]["norm1"].abs().max()) == 0.0
    # Same seed, same parameters; another seed, others.
    assert torch.equal(Model(cfg, "cpu").init(0)["head"], tp["head"])
    assert not torch.equal(Model(cfg, "cpu").init(1)["head"], tp["head"])


@pytest.mark.parametrize("change", [
    {"block_pattern": ("cross",)}, {"block_pattern": ("attn_moe",)},
    {"block_pattern": ("mla",)}, {"block_pattern": ("rec", "rec", "local")},
])
def test_unported_configs_raise(change):
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(cfg, "cpu")


def test_config_registry():
    assert get_config("deepseek_7b").d_model == 4096
    # phi3_mini_3p8b, the two MoE archs and recurrentgemma_2b are the
    # reference's configs, FULL and smoke (their MoECfg / MLACfg / RnnCfg
    # compared as dataclass fields)
    for arch in ("phi3_mini_3p8b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
                 "recurrentgemma_2b"):
        for port, ref in ((get_config, j_config), (get_smoke_config, j_smoke)):
            tc, jc = port(arch), ref(arch)
            for f in dataclasses.fields(tc):
                if (f.name in ("moe", "mla", "rnn")
                        and getattr(jc, f.name) is not None):
                    assert (dataclasses.asdict(getattr(tc, f.name))
                            == dataclasses.asdict(getattr(jc, f.name))), f.name
                elif f.name != "mole":
                    assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    full = get_config("phi3_mini_3p8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim,
            full.vocab) == (32, 3072, 32, 96, 32064)
    with pytest.raises(NotImplementedError, match="unknown or not ported"):
        get_smoke_config("no_such_arch")
