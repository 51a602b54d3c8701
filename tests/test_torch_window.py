"""The port's dense attention stacks beyond global attention on the CPU
against the JAX reference: ``gemma2_27b`` (local/global layers, a sliding
window with ring-buffer KV caches, soft-caps, post-norms, GeGLU, scaled
tied embeddings) and ``command_r_35b`` (a parallel block on one shared
LayerNorm, GQA 64/8, tied embeddings) at their smoke configs, and prefix /
suffix layers.

Inputs come from numpy with a seed; the reference's parameters carry over
with ``params_from_jax``.  Tolerance: rtol 1e-5 in fp32 with an absolute
floor of 1e-5 times the array's largest magnitude (as in
``test_torch_models.py``).  A whole model's logits over a run of 12 and
more decode steps are held within 1e-5, or within four times the
reference's own departure from a float64 evaluation of the same model where
that is larger (:func:`_lm_parity.hold_model`): at the gemma2 smoke config the
reference departs from it by up to 1.0e-5 of max|logit| (3.2e-5 through the
flash scan), and the port as far, so two fp32 summation orders cannot be
held to 1e-5 at every step; at command_r's the bound stays 1e-5.  The gemma2 smoke window is 8 positions, so prompts
of 12 and more wrap its ring.  Decode steps are teacher forced with the
reference's greedy token, so a near-tie cannot part the two runs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as jB, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Model, blocks as tB, params_from_jax, stack as tS,
)
from _lm_parity import hold_model  # noqa: E402

RTOL = 1e-5
ARCHS = ["gemma2_27b", "command_r_35b", "recurrentgemma_2b"]
FLASH = dict(dense_attn_max_seq=16, flash_block_kv=16)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        rtol=rtol, atol=rtol * float(np.abs(want).max()),
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _both(arch, **change):
    return (dataclasses.replace(get_smoke_config(arch), **change),
            dataclasses.replace(j_smoke(arch), **change))


def _ring_pos(S: int, slots: int) -> np.ndarray:
    """A ring of ``slots`` after a prefill of ``S`` positions: the last
    ``min(S, slots)``, position p in slot p % slots, the rest empty."""
    pos = -np.ones(slots, np.int64)
    held = np.arange(max(0, S - slots), S)
    pos[held % slots] = held
    return pos


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_config_is_the_reference_config(arch, full):
    """``FULL`` and ``smoke()`` copy the reference's field for field."""
    port, ref = ((get_config, j_config) if full
                 else (get_smoke_config, j_smoke))
    tc, jc = port(arch), ref(arch)
    for f in dataclasses.fields(tc):
        if f.name == "rnn" and jc.rnn is not None:
            assert dataclasses.asdict(tc.rnn) == dataclasses.asdict(jc.rnn)
        elif f.name != "mole":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    Model(tc, "cpu")            # supported: raises nothing


@pytest.mark.parametrize("S", [5, 12], ids=["inside", "wrapped"])
def test_local_block_full_and_decode_through_a_wrap(rng, S):
    """One ``local`` block (window 8) of the gemma2 smoke config: a prefill
    of S positions writing its ring (12 wraps it), then 10 decode steps
    that write slot t % 8 and mask positions at or before t - 8, against
    ``repro.models.stack.apply_block``: outputs, the ring's K/V and the
    position each slot holds."""
    cfg, jcfg = _both("gemma2_27b")
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
    jblock = jax.tree.map(lambda a: a[0], jp["blocks"]["b0"])
    jblock = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        jblock,
    )   # non-zero norms
    one = dataclasses.replace(cfg, block_pattern=("local",), n_groups=1)
    tblock = params_from_jax(
        {"embed": jp["embed"], "blocks": {"b0": jax.tree.map(
            lambda a: a[None], jblock)}}, one, device="cpu",
    )["blocks"][0]
    max_len = 32
    window = cfg.sliding_window
    h = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jcache = jax.tree.map(lambda a: a[0],
                          JModel(jcfg).init_cache(2, max_len)["blocks"]["b0"])
    tcache = Model(cfg, "cpu").init_cache(2, max_len)["blocks"][0]
    assert tuple(tcache["k"].shape[:2]) == (2, window)

    jout, jcache = jS.apply_block(
        jblock, jnp.asarray(h), jcfg, "local",
        jB.RunState(mode="full", write_cache=True), jcache,
    )
    tout, tcache = tS.apply_block(
        tblock, _t(h), cfg, tB.RunState(mode="full", write_cache=True),
        tcache, "local",
    )
    _close(tout, jout)
    _close(tcache["k"], jcache["k"])
    assert (tcache["pos"] == _t(_ring_pos(S, window))).all()

    for t in range(S, S + 10):
        h1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jS.apply_block(
            jblock, jnp.asarray(h1), jcfg, "local",
            jB.RunState(mode="decode", t=jnp.asarray(t)), jcache,
        )
        tout, tcache = tS.apply_block(
            tblock, _t(h1), cfg, tB.RunState(mode="decode", t=t), tcache,
            "local",
        )
        _close(tout, jout)
        _close(tcache["v"], jcache["v"])
        np.testing.assert_array_equal(tcache["pos"][0].numpy(),
                                      np.asarray(jcache["pos"]))
    assert (tcache["pos"] == _t(_ring_pos(S + 10, window))).all()


def test_per_row_positions_write_each_rows_own_slot(rng):
    """A batched decode step with per-row positions (the decode lane's):
    each row writes slot t[r] % 8 of its own ring and masks by its own t,
    equal to each row stepped alone."""
    cfg, _ = _both("gemma2_27b")
    model = Model(cfg, "cpu")
    params = model.init(0)
    block = params["blocks"][0]
    caches = model.init_cache(2, 32)["blocks"][0]
    h = _t(rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32))
    tS.apply_block(block, h, cfg, tB.RunState(mode="full", write_cache=True),
                   caches, "local")
    alone = [{k: c[r : r + 1].clone() for k, c in caches.items()}
             for r in range(2)]
    t = torch.tensor([11, 14])
    for r in range(2):          # row 1 first steps to 14 on its own
        for tt in range(11, int(t[r])):
            x = _t(rng.standard_normal((1, 1, cfg.d_model)).astype(np.float32))
            tS.apply_block(block, x, cfg, tB.RunState(mode="decode", t=tt),
                           alone[r], "local")
            if r == 1:
                tS.apply_block(
                    block, x, cfg, tB.RunState(mode="decode", t=tt),
                    {k: c[1:2] for k, c in caches.items()}, "local")
    x = _t(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))
    got, _ = tS.apply_block(block, x, cfg, tB.RunState(mode="decode", t=t),
                            caches, "local")
    for r in range(2):
        want, _ = tS.apply_block(
            block, x[r : r + 1], cfg,
            tB.RunState(mode="decode", t=int(t[r])), alone[r], "local")
        _close(got[r : r + 1], want)
        assert int(caches["pos"][r, int(t[r]) % 8]) == int(t[r])
        assert torch.equal(caches["pos"][r], alone[r]["pos"][0])


def test_global_prefill_past_the_cache_raises():
    """A global layer's cache holds every position: a prefill longer than
    it is refused; a local layer's ring keeps the last ``window``."""
    cfg, _ = _both("gemma2_27b")
    model = Model(cfg, "cpu")
    caches = model.init_cache(1, 10)
    tokens = torch.zeros((1, 12), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds the cache"):
        model.prefill_with_cache(model.init(0), {"tokens": tokens}, caches)
    assert [tuple(c["k"].shape[:2]) for c in caches["blocks"]] == [
        (1, 8), (1, 10)] * cfg.n_groups


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_and_decode_match_reference(rng, arch, attention):
    """Forward, prefill and 13 decode steps of the whole smoke model against
    ``repro.models.stack`` / ``repro.models.api.Model`` (:func:`_lm_parity.hold_model`):
    a 12-token prompt (dense attention), or 32 tokens with
    ``dense_attn_max_seq`` 16 and KV blocks of 16 (the flash scan); both
    past gemma2's window of 8, so every local layer's ring wraps in the
    prefill and again in the decode."""
    change = FLASH if attention == "flash" else {}
    cfg, jcfg = _both(arch, **change)
    S = 32 if attention == "flash" else 12
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    tc, _ = hold_model(cfg, jcfg, tokens, n_decode=13,
                        tol=RTOL if arch == "command_r_35b" else None)
    for c, kind in zip(tc["blocks"], cfg.layer_kinds()):
        if kind == "local":
            assert (c["pos"] == _t(_ring_pos(S + 13, 8))).all()


def test_prefix_and_suffix_layers_match_reference(rng):
    """A deepseek_7b smoke stack with an ``attn`` prefix layer and a
    ``local`` suffix layer (window 8) around its 2 scanned layers: the
    schema, parameter count, forward, prefill and 12 decode steps against
    the reference, whose prefix and suffix sit outside its scan."""
    change = dict(prefix_pattern=("attn",), suffix_pattern=("local",),
                  sliding_window=8)
    cfg, jcfg = _both("deepseek_7b", **change)
    assert cfg.layer_kinds() == ["attn", "attn", "attn", "local"]
    assert Model(cfg, "cpu").param_count() == JModel(jcfg).param_count()
    tokens = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    tc, _ = hold_model(cfg, jcfg, tokens, n_decode=12, seed=3)
    assert tuple(tc["blocks"][-1]["k"].shape[:2]) == (2, 8)


def test_readmitted_row_starts_clean_after_its_ring_wrapped():
    """A decode lane of one row at the gemma2 smoke config: a sequence
    whose 6-token prompt and 10 generated tokens wrap the ring of 8, then
    another admitted into the same row.  The second generation equals the
    same request in a fresh lane bit for bit: the joiner's prefill empties
    the row's slots, so no position of its predecessor is seen."""
    cfg = get_smoke_config("gemma2_27b")
    model = Model(cfg, "cpu")
    params = model.init(0)
    embed = params["embed"].numpy()
    rng = np.random.default_rng(11)
    first = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    second = rng.integers(0, cfg.vocab, 4).astype(np.int32)

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
