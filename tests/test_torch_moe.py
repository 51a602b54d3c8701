"""The port's fine-grained MoE FFN and the ``deepseek_moe_16b`` model on the
CPU against the JAX reference: ``blocks.apply_moe`` against
``_apply_moe_dense`` (routing, capacity drops, outputs and gradients), the
whole smoke model (logits, caches, a train step), the decode lane and
``serve --mode lm``, and the FULL configs of both MoE archs.

Inputs come from numpy with a seed; the reference's parameters carry over
with ``params_from_jax``.  Tolerances: ``RTOL`` 1e-5 relative with an
absolute floor of 1e-5 times the array's largest magnitude; a whole
model's logits within 1e-5 of max|logit| or four times the reference's own
departure from a float64 evaluation where that is larger
(``_lm_parity.hold_model``; the reference departs from it by up to 1.8e-6
at this config, so the bound stays 1e-5); gradients within 1e-4 of each
leaf's max|reference| and losses within 1e-5 (``tests/test_torch_train.py``'s
``GRAD_TOL`` and ``LOSS_RTOL``).

Capacity is per call (``moe_capacity`` of the call's tokens), which decides
the dropped assignments.  The reference's batched decode lane vmaps a B = 1
step over its rows, so each row routes alone and is never dropped; the
port runs the rows as one batch with ``RunState.row_calls``.  A router
biased towards one expert (:func:`_biased`) makes every token pick it, so
a lane of 12 rows would drop 4 of them if it routed the batch as one call
of 12 (capacity 8), while ``Model.decode`` of 12 rows, one call in both
packages, does drop 4.

Top-k order decides the routing, and the two frameworks may break an exact
tie in the router's probabilities apart.  fp32 products of random routers
give none: :func:`_route_gap` asserts that the k-th and (k+1)-th
probabilities of every token stay at least ``MIN_ROUTE_GAP`` apart, 100
times the fp32 rounding of a probability, wherever a test compares kept
sets.  The whole-model tests of this file and ``test_torch_mla.py`` saw
gaps of 1.3e-5 and more (measured on the port's routings); with the
biased router the first choice takes nearly all the probability and the
second ones lie 2.5e-14 apart, but they weigh about 1e-9 in the output
and those tests count first-choice drops only, so an order flipped there
moves no checked drop and no logit past the bounds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.lm as jlm  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jB  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.models.base import init_params as j_init_params  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import grouped_row_gemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import Model, blocks as tB, params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from _lm_parity import close, hold_lane, hold_model, jitted  # noqa: E402

ARCH = "deepseek_moe_16b"
ARCHS = ["deepseek_moe_16b", "deepseek_v2_lite_16b"]
MIN_ROUTE_GAP = 1e-5
ROWS = 12                    # > 8, the capacity of a call of 12 tokens
BIASED_EXPERT = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(cfg, rng):
    """One MoE FFN's weights as the reference draws them, as numpy."""
    p = j_init_params(jax.random.key(int(rng.integers(1 << 30))),
                      jB.schema_moe(cfg), jnp.float32)
    return jax.tree.map(np.array, p)


def _tree(p):
    """Nested numpy dict -> nested torch dict (the blocks index by name)."""
    return {k: _tree(v) if isinstance(v, dict) else _t(v) for k, v in p.items()}


def _route_gap(probs, k) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over the tokens; asserted above ``MIN_ROUTE_GAP``."""
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    gap = float((top[:, k - 1] - top[:, k]).min())
    assert gap > MIN_ROUTE_GAP, gap
    return gap


def _ref_keep(p, xf, cfg) -> np.ndarray:
    """The reference's kept assignments for one call (``_apply_moe_dense``'s
    own lines: fp32 router, softmax, top-k, token-major cumsum against
    ``moe_capacity``)."""
    m = cfg.moe
    probs = jax.nn.softmax(jnp.asarray(xf, jnp.float32) @ p["router"], -1)
    _route_gap(probs, m.top_k)
    _, top_i = jax.lax.top_k(probs, m.top_k)
    e_flat = top_i.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, m.n_routed, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - 1, e_flat[:, None], 1)
    return np.asarray(pos[:, 0] < jB.moe_capacity(xf.shape[0], cfg))


@pytest.mark.parametrize("cf", [1.5, 0.25])
def test_apply_moe_matches_reference(rng, cf):
    """``apply_moe`` against ``_apply_moe_dense`` on 4 x 32 tokens (mean
    load 32 an expert): at the smoke capacity factor 1.5 (capacity 48) and
    at 0.25 (capacity 8, where most assignments drop): the same kept
    assignments, the same slots, the same output."""
    jcfg = dataclasses.replace(j_smoke(ARCH), moe=dataclasses.replace(
        j_smoke(ARCH).moe, capacity_factor=cf))
    cfg = dataclasses.replace(get_smoke_config(ARCH), moe=jcfg.moe)
    p = _moe_params(cfg, rng)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    want = jB._apply_moe_dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tp = _tree(p)
    got = tB.apply_moe(tp, _t(x), cfg)
    close(got, want)
    route = tB.moe_route(tp, _t(x.reshape(-1, cfg.d_model)), cfg)
    keep = _ref_keep(p, x.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    assert route.capacity == jB.moe_capacity(128, jcfg)
    drops = int((~keep).sum())
    assert (drops > 0) == (cf < 1)
    # kept slots: each assignment's rank in its expert, token-major
    e = route.top_i.reshape(-1).numpy()
    for ex in range(cfg.moe.n_routed):
        mine = np.flatnonzero((e == ex) & keep)
        np.testing.assert_array_equal(route.slot.numpy()[mine],
                                      np.arange(len(mine)))


@pytest.mark.parametrize("cf", [1.5, 0.25])
def test_apply_moe_gradients_match_reference(rng, cf):
    """The gradients of ``sum(apply_moe(x) * c)`` with respect to x and
    every weight (router, the three expert stacks, the shared FFN) against
    ``jax.grad`` of the reference's, with drops (cf 0.25) and without: a
    dropped assignment adds nothing to a gradient in either package."""
    jcfg = dataclasses.replace(j_smoke(ARCH), moe=dataclasses.replace(
        j_smoke(ARCH).moe, capacity_factor=cf))
    cfg = dataclasses.replace(get_smoke_config(ARCH), moe=jcfg.moe)
    p = _moe_params(cfg, rng)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    _ref_keep(p, x.reshape(-1, cfg.d_model), cfg)   # no near-tie
    want = jax.grad(lambda p_, x_: jnp.sum(
        jB._apply_moe_dense(p_, x_, jcfg) * c), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = _tree(p)
    leaves = [tp["router"], tp["wg"], tp["wu"], tp["wd"],
              *tp["shared"].values()]
    xt = _t(x).requires_grad_()
    for leaf in leaves:
        leaf.requires_grad_()
    out = torch.sum(tB.apply_moe(tp, xt, cfg) * _t(c))
    grads = torch.autograd.grad(out, [xt, *leaves])
    wp, wx = want
    names = ["x", "router", "wg", "wu", "wd",
             *(f"shared.{k}" for k in tp["shared"])]
    refs = [wx, wp["router"], wp["wg"], wp["wu"], wp["wd"],
            *wp["shared"].values()]
    for name, g, w in zip(names, grads, refs):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_row_calls_route_each_row_alone(rng):
    """``row_calls``: 12 rows of one token, all routed to one expert, as
    12 calls (the lane's rule): nothing is dropped, and the output equals
    the reference's ``_apply_moe_dense`` vmapped over B = 1 rows (its lane
    step); as one call of 12 (capacity 8) four rows lose that expert, as
    in the reference's one call of 12."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    p = _moe_params(cfg, rng)
    p["router"][:, BIASED_EXPERT] += 0.1
    x = rng.standard_normal((ROWS, 1, cfg.d_model)).astype(np.float32) + 1.0
    jp = jax.tree.map(jnp.asarray, p)
    want = jax.jit(jax.vmap(
        lambda xr: jB._apply_moe_dense(jp, xr[None], jcfg)[0]))(jnp.asarray(x))
    tp = _tree(p)
    xf = _t(x.reshape(ROWS, cfg.d_model))
    rows = tB.moe_route(tp, xf, cfg, calls=ROWS)
    assert (rows.top_i[:, 0] == BIASED_EXPERT).all()
    assert bool(rows.keep.all()) and rows.capacity == ROWS
    close(tB.apply_moe(tp, _t(x), cfg, row_calls=True), want)
    one = tB.moe_route(tp, xf, cfg)
    keep = _ref_keep(p, x.reshape(ROWS, cfg.d_model), cfg)
    np.testing.assert_array_equal(one.keep.numpy(), keep)
    assert int((~one.keep[::cfg.moe.top_k]).sum()) == ROWS - 8
    close(tB.apply_moe(tp, _t(x), cfg),
          jB._apply_moe_dense(jp, jnp.asarray(x), jcfg))


# -- the whole model ------------------------------------------------------------

def _biased(np_params, cfg):
    """A reference parameter tree whose every token picks one expert first
    in every MoE layer: a shared direction u added to every embedding row
    (the token's own part is kept), so that the tokens' inputs to each MoE
    layer share a common direction m (their mean over 64 random tokens,
    read layer by layer from the port's forward), and 4 m added to that
    expert's router column: its logit then exceeds the others' by several
    units."""
    u = np.random.default_rng(7).standard_normal(np_params["embed"].shape[1])
    out = jax.tree.map(np.array, np_params)
    out["embed"] += (0.2 * u / np.linalg.norm(u)).astype(np.float32)
    router = out["blocks"]["b0"]["ffn"]["router"]     # (n_groups, d, E)
    tokens = _t(np.random.default_rng(8).integers(0, cfg.vocab, (4, 16)))
    real = tB.moe_route
    for g in range(cfg.n_groups):
        seen = []
        tB.moe_route = lambda p, xf, c, calls=1: seen.append(xf) or real(
            p, xf, c, calls)
        try:
            with torch.no_grad():
                Model(cfg, "cpu").logits(params_from_jax(out, cfg, "cpu"),
                                         {"tokens": tokens})
        finally:
            tB.moe_route = real
        m = seen[g].double().mean(0).numpy()
        router[g, :, BIASED_EXPERT] += (4 * m / np.linalg.norm(m)).astype(
            np.float32)
    return out


class _RouteLog:
    """Records each ``moe_route`` call: its ``calls``, its tokens, the
    top-1 assignments it drops, those a single call of its tokens would
    drop, and the tokens whose top-1 is the biased expert."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tB.moe_route

        def spy(p, xf, cfg, calls=1):
            r = real(p, xf, cfg, calls)
            alone = real(p, xf, cfg, 1)
            first = slice(None, None, cfg.moe.top_k)   # top-1 assignments
            self.calls.append((calls, xf.shape[0], int((~r.keep[first]).sum()),
                               int((~alone.keep[first]).sum()),
                               int((r.top_i[:, 0] == BIASED_EXPERT).sum())))
            return r

        monkeypatch.setattr(tB, "moe_route", spy)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_model_prefill_and_decode_match_reference(rng, attention):
    """Forward, prefill and 8 decode steps of the smoke model against the
    reference (:func:`_lm_parity.hold_model`): 12 tokens dense, or 32 with
    ``dense_attn_max_seq`` and the KV block at 16 (the flash scan)."""
    change = (dict(dense_attn_max_seq=16, flash_block_kv=16)
              if attention == "flash" else {})
    cfg = dataclasses.replace(get_smoke_config(ARCH), **change)
    jcfg = dataclasses.replace(j_smoke(ARCH), **change)
    S = 32 if attention == "flash" else 12
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    hold_model(cfg, jcfg, tokens, n_decode=8)


def test_model_decode_routes_the_batch_as_one_call(rng, monkeypatch):
    """``Model.decode`` of 12 rows is one call of 12 tokens in both
    packages (T = B capacity, 8): with the biased router every row picks
    one expert and 4 of them are dropped there, in each MoE layer, and
    the logits still equal the reference's ``decode``."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    np_params = _biased(jax.tree.map(
        np.asarray, JModel(jcfg).init(jax.random.key(1))), cfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_jax(np_params, cfg, "cpu")
    tokens = rng.integers(0, cfg.vocab, (ROWS, 6)).astype(np.int32)
    tm = Model(cfg, "cpu")
    jprefill, jdecode = jitted(jcfg, 10)
    jlg, jc = jprefill(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tlg, tc = tm.prefill(params, {"tokens": _t(tokens)}, 10)
        close(tlg, jlg)
        tok = np.asarray(jnp.argmax(jlg[:, 0], -1), np.int32)[:, None]
        log = _RouteLog(monkeypatch)
        tlg, _ = tm.decode(params, _t(tok), 6, tc)
    jlg, _ = jdecode(jparams, jnp.asarray(tok), jnp.asarray(6), jc)
    close(tlg, jlg)
    assert [c[:3] for c in log.calls] == [(1, ROWS, ROWS - 8)] * cfg.n_groups
    assert all(c[4] == ROWS for c in log.calls)


@pytest.fixture(scope="module")
def biased_lanes():
    """The smoke model in both packages with the biased router, 12 tenants
    registered in the reference's registry, and the reference lane's
    generations on 12 rows for 16 requests (rows retire and re-join)."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    np_params = _biased(jax.tree.map(
        np.asarray, JModel(jcfg).init(jax.random.key(0))), cfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32)
               for _ in range(16)]
    gens = [int(g) for g in rng.integers(2, 7, 16)]
    jreg = jlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=ROWS)
    for i in range(ROWS):
        jreg.register(f"t{i}", np_params["embed"], seed=40 + i,
                      head=np_params["head"])
    lane = jrt.ContinuousDecodeLane(JModel(jcfg), jparams, jreg, rows=ROWS,
                                    max_len=16)
    sids = [lane.submit(f"t{r % ROWS}", prompts[r], gens[r])
            for r in range(16)]
    lane.run()
    return {"cfg": cfg, "jcfg": jcfg, "jparams": jparams,
            "params": params_from_jax(np_params, cfg, "cpu"),
            "prompts": prompts, "gens": gens,
            "snapshot": jreg.snapshot_state(),
            "want": [np.asarray(lane.take(s)) for s in sids]}


def test_lane_routes_each_row_alone(biased_lanes, monkeypatch):
    """The port's decode lane on the reference lane's 12 rows and traffic:
    every batched decode step routes its rows as 12 calls and drops no
    assignment, although more than 8 rows pick the same expert first, so
    that one call of 12 (capacity 8) would drop the rest (the port's
    ``row_calls``; the reference vmaps a B = 1 step), and every generation
    is held to the reference lane's (``hold_lane``, whose reference logits
    come from the same per-sequence calls)."""
    b = biased_lanes
    reg = tlm.LMSessionRegistry(b["cfg"].vocab, b["cfg"].d_model,
                                capacity=ROWS)
    reg.restore_state(*b["snapshot"])
    lane = trt.ContinuousDecodeLane(Model(b["cfg"], "cpu"), b["params"], reg,
                                    rows=ROWS, max_len=16, device="cpu")
    log = _RouteLog(monkeypatch)
    sids = [lane.submit(f"t{r % ROWS}", b["prompts"][r], b["gens"][r])
            for r in range(16)]
    lane.run()
    got = [lane.take(s) for s in sids]
    assert hold_lane(b["jparams"], b["jcfg"], b["prompts"], got,
                     b["want"]) > 0
    steps = [c for c in log.calls if c[0] > 1]
    assert steps and all(c[:3] == (ROWS, ROWS, 0) for c in steps)
    # more than 8 rows (all 12 while every row is live) share the expert:
    # one call of 12 would drop those past its capacity of 8
    assert all(c[4] > 8 and c[3] == c[4] - 8 for c in steps)
    assert steps[0][4] == ROWS
    prefills = [c for c in log.calls if c[0] == 1]
    assert len(prefills) == 16 * b["cfg"].n_groups
    assert all(c[1] == 6 and c[2] == 0 for c in prefills)


def test_serve_lm_matches_reference_cli(capsys):
    """``serve --mode lm --arch deepseek_moe_16b --smoke`` on the CPU with the
    reference's weights: ``--mole off`` (one prefill of 4 prompts, a call
    of 64 tokens, then decode steps of 4) against the reference
    launcher's, and ``--mole token`` (the lane) against it, each held token
    for token where the reference decides.  The CPU launches no kernel."""
    flags = ["--mode", "lm", "--arch", ARCH, "--smoke", "--requests", "4",
             "--prompt-len", "16", "--gen", "4"]
    want = np.asarray(jserve.main([*flags, "--mole", "off"]))
    assert f"arch={ARCH}" in capsys.readouterr().out
    jcfg = j_smoke(ARCH)
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_smoke_config(ARCH), device="cpu")
    prompts = np.asarray(SyntheticLM(DataConfig(
        vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0)).batch(0)["tokens"])
    before = grouped_row_gemm.launches
    for mole in ("off", "token"):
        got = tserve.run_lm(tserve.parse_args(
            [*flags, "--mole", mole, "--device", "cpu"]), params=params)
        assert got.shape == (4, 4) == want.shape
        assert hold_lane(jparams, jcfg, prompts, got, want) > 0
    assert grouped_row_gemm.launches == before
    assert "mole=token device=cpu" in capsys.readouterr().out


def test_moe_routes_to_multiple_experts(rng, monkeypatch):
    """``tests/test_models_smoke.py::test_moe_routes_to_multiple_experts``
    on the port: other tokens, other logits; and the tokens of one batch
    reach most experts of every MoE layer."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    params = model.init(3)
    tokens = _t(rng.integers(0, cfg.vocab, (2, 16)))
    seen = []
    real = tB.moe_route

    def spy(p, xf, cfg_, calls=1):
        r = real(p, xf, cfg_, calls)
        seen.append(set(r.top_i.reshape(-1).tolist()))
        return r

    monkeypatch.setattr(tB, "moe_route", spy)
    l1 = model.logits(params, {"tokens": tokens})
    monkeypatch.undo()
    l2 = model.logits(params, {"tokens": (tokens + 17) % cfg.vocab})
    assert not torch.allclose(l1, l2)
    assert len(seen) == cfg.n_groups
    assert all(len(s) >= cfg.moe.n_routed // 2 for s in seen)


# -- decode and training on the port alone ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(rng, arch):
    """``tests/test_models_smoke.py::test_decode_matches_forward`` on the
    port: a prefill of 12 tokens and one decode step equal the full
    forward's logits at position 12 (atol 2e-3, the reference's)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu")
    params = model.init(2)
    toks = _t(rng.integers(0, cfg.vocab, (2, 13)))
    full = model.logits(params, {"tokens": toks})
    _, caches = model.prefill(params, {"tokens": toks[:, :12]}, 16)
    dec, _ = model.decode(params, toks[:, 12:13], 12, caches)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, 12].numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(rng, arch):
    """``tests/test_models_smoke.py::test_one_train_step`` on the port."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, "cpu")
    params = model.init(1)
    before = [p.detach().clone() for p in params.parameters()]
    step = make_train_step(model, TrainHParams(microbatch=2))
    batch = {k: _t(rng.integers(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "targets")}
    _, opt, metrics = step(params, adamw.init_state(params), batch)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert int(opt["count"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, params.parameters()))


# -- the FULL configs ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    """``tests/test_models_smoke.py::test_full_config_matches_assignment``
    for the two MoE archs: layers, width, heads, expert width and vocab."""
    spec = {"deepseek_moe_16b": (28, 2048, 16, 16, 1408, 102400),
            "deepseek_v2_lite_16b": (27, 2048, 16, 16, 1408, 102400)}[arch]
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == spec
    assert cfg.moe.n_routed == 64 and cfg.moe.top_k == 6
    assert cfg.moe.first_dense_ff == 10944


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_full_configs(arch):
    """Total and active parameters of the FULL and smoke configs equal the
    reference's (counted from the schema, nothing allocated): 16.376 B and
    15.706 B in all, 2.829 B and 2.661 B active a token."""
    for port, ref in ((get_config, j_config), (get_smoke_config, j_smoke)):
        tc, jc = port(arch), ref(arch)
        assert tc.param_count() == jc.param_count()
        assert Model(tc, "cpu").param_count() == JModel(jc).param_count()
        assert tc.active_param_count() == jc.active_param_count()
    full = get_config(arch)
    want = {"deepseek_moe_16b": (16_375_728_128, 2_828_650_496),
            "deepseek_v2_lite_16b": (15_706_484_224, 2_661_150_208)}[arch]
    assert (full.param_count(), full.active_param_count()) == want
