"""The port's RWKV-6 model path on the CPU against the JAX reference: the
``rwkv6_3b`` smoke model (4 heads of 16, 2 layers, d 64, vocab 512, fp32;
and bf16), token MoLe on its logits, the decode lane and ``serve --mode
lm --arch rwkv6_3b``.  The scan and the blocks are held in
``test_torch_rwkv.py``.

The reference's parameters carry over with ``params_from_jax``; inputs
come from numpy with a seed.  Every comparison between the two packages
is of numbers within a stated tolerance, never of raw token sequences: a
CPU matmul sums in an order that depends on the machine (instruction set,
threads, shapes), so two logits that are nearly tied may swap on one
machine and not on another.  Tokens are compared only where the
reference's top-1/top-2 logit gap exceeds ``GAP_MARGIN`` x max|logit| of
that position (see :func:`_hold_lane`).  Tolerances:

  * the model logits: ``LOGIT_RTOL`` 1e-5 with an absolute floor of 1e-5 x
    max, as ``test_torch_models.py``; decode against forward: the
    reference's own atol 2e-3 (``tests/test_models_smoke.py``);
  * ``GAP_MARGIN`` 1e-4 of max|logit|: five times the largest logit
    difference the logit checks admit (2e-5 x max), so above it no
    admitted difference can change the argmax;
  * bf16: see :func:`test_bf16_forward_parity`.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import grouped_row_gemm, wkv6_chunked  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step,
)
from repro_torch.models import (  # noqa: E402
    Model, check_supported, params_from_jax, stack as tS,
)
from _lm_parity import decided as _decided, hold_lane as _hold_lane  # noqa: E402

ARCH = "rwkv6_3b"
LOGIT_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want,
        rtol=rtol, atol=rtol * float(np.abs(want).max()),
    )


def _jparams(cfg, seed=0):
    params = JModel(cfg).init(jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_lm():
    """The fp32 smoke model in both packages, the same weights."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    jparams, jp = _jparams(jcfg)
    return cfg, jcfg, jparams, params_from_jax(jp, cfg, device="cpu")


def test_forward_and_decode_logits_match_reference(rng, smoke_lm):
    """The forward, then a prefill and three greedy decode steps at the
    smoke config: logits within rtol 1e-5 of the reference at every step.
    Both packages are fed the reference's greedy token at each step
    (teacher-forced), so one near-tie cannot steer the two apart; the
    port's argmax equals the reference's wherever the reference's top-2 gap
    exceeds the margin."""
    cfg, jcfg, jparams, tparams = smoke_lm
    jm, tm = JModel(jcfg), Model(cfg, "cpu")
    tokens = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)

    jl, _ = jS.forward(jparams, jcfg, jnp.asarray(tokens))
    tl_, _ = tS.forward(tparams, cfg, _t(tokens))
    _close(tl_, jl)

    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    jlog, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :6])}, 12)
    tlog, tc = prefill(tparams, {"tokens": _t(tokens[:, :6])},
                       tm.init_cache(2, 12))
    n_decided = 0
    for i in range(4):
        _close(tlog, jlog)
        want = np.asarray(jlog[:, 0])
        decided = _decided(want)
        n_decided += int(decided.sum())
        np.testing.assert_array_equal(
            tlog[:, 0].argmax(-1).numpy()[decided], want.argmax(-1)[decided])
        if i == 3:
            break
        tok = want.argmax(-1).astype(np.int32)[:, None]
        jlog, jc = jm.decode(jparams, jnp.asarray(tok), jnp.asarray(6 + i), jc)
        tlog, tc = decode(tparams, _t(tok), 6 + i, tc)
    assert n_decided >= 4, f"only {n_decided} of 8 steps are decided"


def test_decode_matches_forward(rng, smoke_lm):
    """The port's decode against its own forward on the same tokens (the
    reference's decode-vs-forward check, atol 2e-3): the recurrent state
    and token-shift rows the prefill leaves continue the sequence."""
    cfg, _, _, tparams = smoke_lm
    tm = Model(cfg, "cpu")
    tokens = _t(rng.integers(0, cfg.vocab, (2, 10)).astype(np.int64))
    full, _ = tS.forward(tparams, cfg, tokens)
    prefill, decode = make_prefill_step(tm), make_decode_step(tm)
    _, tc = prefill(tparams, {"tokens": tokens[:, :6]}, tm.init_cache(2, 12))
    for i in range(6, 10):
        dl, tc = decode(tparams, tokens[:, i : i + 1], i, tc)
        np.testing.assert_allclose(dl[:, 0].numpy(), full[:, i].numpy(),
                                   atol=2e-3)


def test_token_mole_equivalence_on_logits(rng):
    """Token MoLe (``tests/test_mole_lm.py:56`` on logits, the port has no
    loss yet): the smoke model on morphed tokens with the Aug-Embedding and
    Aug-head gives the raw model's logits in morphed vocabulary order,
    within rtol 1e-5 (the reference's own tolerance there: the head's
    columns are permuted, so a matmul may sum them in another order)."""
    cfg = get_smoke_config(ARCH)
    params = Model(cfg, "cpu").init(0)
    tmo = tlm.TokenMorpher.create(7, cfg.vocab)
    tokens = _t(rng.integers(0, cfg.vocab, (2, 9)).astype(np.int64))
    fused = {k: params[k] for k in ("final_norm", "blocks")}
    fused["embed"] = _t(tlm.fuse_aug_embedding(params["embed"].numpy(), tmo))
    fused["head"] = _t(tlm.fuse_aug_head(params["head"].numpy(), tmo))
    raw, _ = tS.forward(params, cfg, tokens)
    morphed, _ = tS.forward(fused, cfg, tmo.morph_tokens(tokens))
    _close(morphed[..., torch.from_numpy(tmo.perm)], raw)


def test_bf16_forward_parity(rng):
    """The smoke config in bf16 on both sides, the same bf16 weights, 4 x 32
    tokens.  bf16 rounds at other places in the two frameworks, so the port
    is not held to the reference's bf16 logits but to what bf16 costs the
    reference: ``e_ref = max|ref_bf16 - ref_fp32|``, its own distance from
    an fp32 forward of the same weights.  The bound is ``2 e_ref`` on the
    port's distance from that fp32 forward, in the largest deviation and in
    the root mean square (two independent bf16 forwards, each rounding as
    often as the other, land within the same size of error).

    Agreement is then judged position by position from the fp32 forward's
    top-1/top-2 gap: where it exceeds twice the bound, no admitted error
    can reorder the top two, and the port's argmax is the fp32 argmax;
    everywhere the port's pick lies within twice the bound of the fp32
    maximum.  The reference's bf16 forward is held to the same standard."""
    cfg16 = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16",
                                param_dtype="bfloat16")
    jcfg16 = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16",
                                 param_dtype="bfloat16")
    jcfg32 = j_smoke(ARCH)
    jparams, jp = _jparams(jcfg16)
    tparams = params_from_jax(jp, cfg16, device="cpu")
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    tokens = jnp.asarray(rng.integers(0, cfg16.vocab, (4, 32)), jnp.int32)

    ref16 = np.asarray(jS.forward(jparams, jcfg16, tokens)[0], np.float64)
    ref32 = np.asarray(jS.forward(p32, jcfg32, tokens)[0], np.float64)
    port16 = tS.forward(tparams, cfg16, _t(np.asarray(tokens)))[0]
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
    assert decided.any()
    for got in (port16, ref16):
        pick = got.argmax(-1)
        np.testing.assert_array_equal(pick[decided], ref32.argmax(-1)[decided])
        picked = np.take_along_axis(ref32, pick[..., None], -1)[..., 0]
        assert float((top2[..., 1] - picked).max()) <= 2 * bound


def test_model_init_and_support():
    """``Model.init`` draws the reference's shapes for an rwkv tree (the
    (5, d) / (5, rank, d) ddlerp tensors, the (H, hd) bonus ``u``, the
    normal-initialised ``w0``); the registry carries both configs; rwkv
    blocks with another norm or family are refused."""
    cfg = get_smoke_config(ARCH)
    tp = Model(cfg, "cpu").init(0)
    _, jp = _jparams(j_smoke(ARCH))
    jb = jp["blocks"]["b0"]
    assert len(tp["blocks"]) == cfg.n_groups == 2
    for part, names in (("mix", ("maa", "A", "B", "w0", "u", "wo")),
                        ("ffn", ("maa_k", "wk", "wv"))):
        for n in names:
            assert tuple(tp["blocks"][1][part][n].shape) == jb[part][n].shape[1:]
    assert float(tp["blocks"][0]["mix"]["w0"].std()) > 0.5
    cache = Model(cfg, "cpu").init_cache(3, 8)["blocks"][0]
    assert cache["s"].shape == (3, 4, 16, 16) and cache["s"].dtype == torch.float32
    assert cache["tm_x"].shape == cache["cm_x"].shape == (3, 64)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab) == (32, 2560, 8960, 65536)
    assert full.rwkv.chunk == 128 and full.d_model // full.rwkv.head_dim == 40
    for change in ({"norm": "rmsnorm"}, {"family": "dense"}, {"rwkv": None}):
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(dataclasses.replace(cfg, **change))


# ---------------------------------------------------------------------------
# The decode lane and serve --mode lm
# ---------------------------------------------------------------------------

PROMPT_LEN, MAX_LEN, TENANTS = 9, 24, 6
GENS = [3, 6, 4, 8, 2, 5]


@pytest.fixture(scope="module")
def lm():
    """The smoke model in both packages and the reference lane's
    generations for one traffic set (prompts of 9 over chunk 4: every
    admission prefill pads)."""
    class LM:
        pass

    m = LM()
    m.jcfg, m.cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    m.jmodel = JModel(m.jcfg)
    m.jparams = m.jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, m.jparams)
    m.model = Model(m.cfg, "cpu")
    m.params = params_from_jax(np_params, m.cfg, device="cpu")
    rng = np.random.default_rng(3)
    m.prompts = [rng.integers(0, m.cfg.vocab, PROMPT_LEN).astype(np.int32)
                 for _ in range(TENANTS)]

    def jregistry():
        reg = jlm.LMSessionRegistry(m.cfg.vocab, m.cfg.d_model, capacity=TENANTS)
        for i in range(TENANTS):
            reg.register(f"t{i}", np_params["embed"], seed=100 + i,
                         head=np_params["head"])
        return reg

    m.jregistry = jregistry
    lane = jrt.ContinuousDecodeLane(m.jmodel, m.jparams, jregistry(), rows=2,
                                    max_len=MAX_LEN)
    sids = [lane.submit(f"t{i}", m.prompts[i], GENS[i]) for i in range(TENANTS)]
    lane.run()
    m.want = [np.asarray(lane.take(s)) for s in sids]
    return m


def _port_lane(lm, rows):
    reg = tlm.LMSessionRegistry(lm.cfg.vocab, lm.cfg.d_model, capacity=TENANTS)
    reg.restore_state(*lm.jregistry().snapshot_state())
    return trt.ContinuousDecodeLane(lm.model, lm.params, reg, rows=rows,
                                    max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("rows,order", [(2, range(TENANTS)),
                                        (3, [4, 1, 5, 0, 3, 2])])
def test_decode_lane_churn_matches_reference(lm, rows, order):
    """More tenants than rows with ragged generation lengths: rows retire
    and joiners prefill into freed rows whose RWKV state and token-shift
    rows the lane resets (``_row_caches``); the results are held to the
    reference lane's by :func:`_hold_lane`, and the reset leaves a freed
    row's state zero while the other rows keep theirs."""
    lane = _port_lane(lm, rows)
    sids = {i: lane.submit(f"t{i}", lm.prompts[i], GENS[i]) for i in order}
    lane.run()
    got = {i: lane.take(sid) for i, sid in sids.items()}
    _hold_lane(lm.jparams, lm.jcfg, lm.prompts,
               [got[i] for i in range(TENANTS)], lm.want)
    view = lane._row_caches(0)["blocks"]
    assert all(float(c[n].abs().max()) == 0.0 for c in view
               for n in ("s", "tm_x", "cm_x"))
    assert float(lane._caches["blocks"][0]["s"][1:].abs().max()) > 0.0


def test_decode_lane_restore_replays(lm):
    """Crash between decode steps after a snapshot; the restored lane
    replays every unfinished sequence from its prompt (no ``pos`` in an RWKV
    cache) and its generations are held to the reference lane's by
    :func:`_hold_lane`."""
    lane = _port_lane(lm, 2)
    sids = [lane.submit(f"t{i}", lm.prompts[i], GENS[i]) for i in range(TENANTS)]
    for _ in range(4):
        lane.step()
    snap = lane.snapshot()
    lane.injector = trt.FailureInjector(at_phases={"admit"})
    with pytest.raises(trt.SimulatedFailure):
        lane.run()
    lane.injector = None
    lane.restore(snap)
    lane.run()
    _hold_lane(lm.jparams, lm.jcfg, lm.prompts,
               [lane.take(sid) for sid in sids], lm.want)


def test_serve_lm_rwkv_smoke_matches_reference_cli(capsys):
    """``serve --mode lm --arch rwkv6_3b --smoke --device cpu`` with the
    reference's weights, against the reference launcher (``--backend
    jnp``): the generations held by :func:`_hold_lane` on the launchers'
    prompts (``SyntheticLM`` from ``--seed`` 0), the first one printed the
    same way; the CPU run launches no kernel."""
    flags = ["--mode", "lm", "--arch", ARCH, "--smoke", "--requests", "4",
             "--tenants", "2", "--prompt-len", "13", "--gen", "6"]
    want = jserve.main([*flags, "--backend", "jnp"])
    ref_out = capsys.readouterr().out
    args = tserve.parse_args([*flags, "--device", "cpu"])
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    before = (grouped_row_gemm.launches, wkv6_chunked.launches)
    got = tserve.run_lm(args, params=params)
    port_out = capsys.readouterr().out
    assert (grouped_row_gemm.launches, wkv6_chunked.launches) == before
    prompts = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=13,
                                     global_batch=4, seed=0)).batch(0)["tokens"]
    _hold_lane(jparams, jcfg, np.asarray(prompts), got, np.asarray(want))
    for out, gens in ((ref_out, want), (port_out, got)):
        line = (f"first request generation (provider view): "
                f"{np.asarray(gens)[0][:12].tolist()}")
        assert line in out.splitlines()
