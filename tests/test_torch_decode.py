"""The port's continuous-batched decode lane (``repro_torch.runtime.decode``)
and ``serve --mode lm`` on the CPU against the JAX reference, at the
``deepseek_7b`` smoke config (2 layers, d 64, vocab 512, fp32).

Both packages get the same weights (``params_from_jax``) and the same
tenants (a reference ``LMSessionRegistry`` restored into the port's).  Every
request's unmorphed generation must equal the reference
``ContinuousDecodeLane``'s token for token — across join/leave churn and a
crash-and-restore mid-decode — and the port's own per-tenant plain decode.
One batched decode step's logits are held to the reference's per-tenant
decode on fused parameters within rtol 1e-5 (fp32, sums in other orders).
The lane's Aug-head and AugE stacks take the model's activation type: with
the smoke config in bf16 they are bf16, and every step's logits are the
bits that fp32 stacks give.
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import grouped_row_gemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_batched_decode_logits, make_row_prefill_step,
)
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.runtime.engine import _sync_plan  # noqa: E402
from _lm_parity import hold_lane  # noqa: E402

PROMPT_LEN, MAX_LEN = 8, 24
TENANTS = 8
GENS = [3, 6, 4, 8, 2, 5, 7, 3]


class _LM:
    """The smoke model in both packages, and the reference lane's
    generations for one fixed traffic set, built once per module."""

    def __init__(self):
        self.jcfg = j_smoke("deepseek_7b")
        self.cfg = get_smoke_config("deepseek_7b")
        self.jmodel = JModel(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.key(0))
        self.np_params = jax.tree.map(np.asarray, self.jparams)
        self.model = Model(self.cfg, "cpu")
        self.params = params_from_jax(self.np_params, self.cfg, device="cpu")
        rng = np.random.default_rng(3)
        self.prompts = [rng.integers(0, self.cfg.vocab, PROMPT_LEN)
                        .astype(np.int32) for _ in range(TENANTS)]
        jreg = self.jregistry()
        lane = jrt.ContinuousDecodeLane(self.jmodel, self.jparams, jreg,
                                        rows=3, max_len=MAX_LEN)
        sids = [lane.submit(f"t{i}", self.prompts[i], GENS[i])
                for i in range(TENANTS)]
        lane.run()
        self.want = [np.asarray(lane.take(s)) for s in sids]

    def jregistry(self):
        reg = jlm.LMSessionRegistry(self.cfg.vocab, self.cfg.d_model,
                                    capacity=TENANTS)
        for i in range(TENANTS):
            reg.register(f"t{i}", self.np_params["embed"], seed=100 + i,
                         head=self.np_params["head"])
        return reg

    def registry(self):
        reg = tlm.LMSessionRegistry(self.cfg.vocab, self.cfg.d_model,
                                    capacity=TENANTS)
        reg.restore_state(*self.jregistry().snapshot_state())
        return reg

    def lane(self, rows, **kw):
        return trt.ContinuousDecodeLane(
            self.model, self.params, self.registry(), rows=rows,
            max_len=MAX_LEN, device="cpu", **kw,
        )

    def plain_decode(self, i: int) -> np.ndarray:
        """Greedy generation on the raw (unmorphed) weights, one tenant
        alone: the port's own per-tenant loop."""
        logits, caches = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(self.prompts[i][None])},
            MAX_LEN,
        )
        out = [int(torch.argmax(logits[0, 0]))]
        for j in range(GENS[i] - 1):
            logits, caches = self.model.decode(
                self.params, torch.tensor([[out[-1]]]), PROMPT_LEN + j, caches
            )
            out.append(int(torch.argmax(logits[0, 0])))
        return np.asarray(out, np.int32)


@pytest.fixture(scope="module")
def lm():
    return _LM()


def test_batched_decode_matches_reference_lane_and_plain_decode(lm):
    """All tenants decode in one shared batched step (rows = tenants); after
    the provider unmorph, each equals the reference lane's generation and
    the port's per-tenant plain decode.  On the CPU the fp32 products take
    the same path at every batch width here, so the batched lane is exact
    against the per-tenant loop."""
    lane = lm.lane(rows=TENANTS)
    sids = [lane.submit(f"t{i}", lm.prompts[i], GENS[i])
            for i in range(TENANTS)]
    lane.run()
    for i, sid in enumerate(sids):
        got = lane.take(sid)
        np.testing.assert_array_equal(got, lm.want[i])
        np.testing.assert_array_equal(got, lm.plain_decode(i))


@pytest.mark.parametrize("rows,order", [(3, range(TENANTS)),
                                        (2, [5, 2, 7, 0, 3, 6, 1, 4])])
def test_join_leave_churn_matches_reference(lm, rows, order):
    """More tenants than rows with ragged generation lengths: sequences
    retire and joiners prefill into freed rows mid-decode; every result
    equals the reference lane's."""
    lane = lm.lane(rows=rows)
    sids = {i: lane.submit(f"t{i}", lm.prompts[i], GENS[i]) for i in order}
    steps = 0
    while len(lane.queue) or lane.active:
        lane.step()
        steps += 1
    lane.run()
    assert steps >= max(GENS)
    for i, sid in sids.items():
        np.testing.assert_array_equal(lane.take(sid), lm.want[i])


@pytest.mark.parametrize("phase", ["retire", "admit"])
def test_crash_mid_decode_restores_exactly_once(lm, phase):
    """Crash between decode steps after a snapshot: an in-place restore
    re-queues every unfinished sequence under its seq_id, the replay
    regenerates the reference lane's tokens, and each is taken once."""
    lane = lm.lane(rows=2)
    sids = [lane.submit(f"t{i}", lm.prompts[i], GENS[i])
            for i in range(TENANTS)]
    for _ in range(5):
        lane.step()
    assert 0 < lane.active and len(lane.queue) > 0
    snap = lane.snapshot()
    lane.injector = trt.FailureInjector(at_phases={phase})
    with pytest.raises(trt.SimulatedFailure):
        lane.run()
    lane.injector = None
    restored = lane.restore(snap)
    assert set(restored) | set(snap.meta["finished"]) == set(sids)
    lane.run()
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(lane.take(sid), lm.want[i])
        with pytest.raises(KeyError):
            lane.take(sid)


def test_admission_never_evicts_an_active_tenant(lm):
    """Capacity 3 for 8 tenants and 2 rows: each admission evicts a slot,
    and the lane pins its active tenants first, so the evicted slot is
    never one a row still decodes with — every result stays exact.  A slot
    taken from under a live row by outside traffic is an error, as in the
    reference."""
    reg = tlm.LMSessionRegistry(lm.cfg.vocab, lm.cfg.d_model, capacity=3)
    for i in range(TENANTS):
        reg.register(f"t{i}", lm.np_params["embed"], seed=100 + i,
                     head=lm.np_params["head"])
    lane = trt.ContinuousDecodeLane(lm.model, lm.params, reg, rows=2,
                                    max_len=MAX_LEN, device="cpu")
    sids = {i: lane.submit(f"t{i}", lm.prompts[i], GENS[i])
            for i in range(TENANTS)}
    evictions = reg.evictions
    lane.run()
    assert reg.evictions > evictions
    for i, sid in sids.items():
        np.testing.assert_array_equal(lane.take(sid), lm.want[i])

    sids = {i: lane.submit(f"t{i}", lm.prompts[i], GENS[i]) for i in (3, 6)}
    lane.step()
    for t in ("t0", "t1", "t2"):
        reg.slot_for(t)             # outside traffic takes every slot
    with pytest.raises(RuntimeError, match="lost slot"):
        lane.step()


def test_batched_logits_match_reference_per_tenant_decode(lm):
    """One batched decode step over 3 rows (slots out of order) against the
    reference's per-tenant decode on each tenant's fused parameters
    (embed -> AugE, head -> Aug-head): morphed-order logits within rtol
    1e-5 of max|logit|."""
    reg = lm.registry()
    jreg = lm.jregistry()
    rows = [5, 1, 6]
    caches = lm.model.init_cache(len(rows), MAX_LEN)
    prefill = make_row_prefill_step(lm.model)
    stack = lambda f: torch.from_numpy(np.stack(  # noqa: E731
        [f(s) for s in range(reg.capacity)]))
    aug_e, aug_h = stack(reg.slot_aug_embedding), stack(reg.slot_aug_head)
    toks, want = [], []
    for r, i in enumerate(rows):
        sess = jreg.session(f"t{i}")
        morphed = sess.morpher.perm[lm.prompts[i]].astype(np.int32)
        view = {"blocks": [{k: c[k][r : r + 1] for k in c}
                           for c in caches["blocks"]]}
        slot = reg.slot_for(f"t{i}")
        tok, _ = prefill(lm.params, aug_e[slot], aug_h[slot],
                         torch.from_numpy(morphed[None]), view)
        toks.append(int(tok[0]))
        fused = dict(lm.jparams, embed=jnp.asarray(sess.aug_embedding),
                     head=jnp.asarray(sess.aug_head))
        jl, jc = lm.jmodel.prefill(fused, {"tokens": jnp.asarray(morphed[None])},
                                   MAX_LEN)
        assert int(jnp.argmax(jl[0, 0])) == toks[-1]
        jl, _ = jS.decode_step(fused, lm.jcfg, jnp.asarray([[toks[-1]]]),
                               jnp.asarray(PROMPT_LEN), jc)
        want.append(np.asarray(jl[0, 0]))
    sidx = torch.tensor([reg.slot_for(f"t{i}") for i in rows], dtype=torch.int32)
    logits, _ = make_batched_decode_logits(lm.model)(
        lm.params, aug_e, aug_h, sidx, torch.tensor(toks),
        torch.full((len(rows),), PROMPT_LEN), caches,
    )
    want = np.stack(want)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_lane_runs_on_the_card_unless_asked(lm, monkeypatch):
    """``Model``, the decode lane and ``serve --mode lm`` default to the
    card and raise without one; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(lm.cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trt.ContinuousDecodeLane(lm.model, lm.params, lm.registry(), rows=2,
                                 max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--mode", "lm", "--smoke", "--requests", "2"])
    with pytest.raises(ValueError, match="capacity"):
        trt.ContinuousDecodeLane(
            lm.model, lm.params,
            tlm.LMSessionRegistry(lm.cfg.vocab, lm.cfg.d_model, capacity=1),
            rows=2, max_len=MAX_LEN, device="cpu",
        )


@pytest.mark.parametrize("argv", [["--arch", "no_such_arch"]])
def test_serve_lm_unported_options_raise(argv):
    """An architecture outside the registry is refused, not served some
    other way."""
    with pytest.raises(NotImplementedError, match="not ported"):
        tserve.main(["--mode", "lm", "--smoke", "--device", "cpu", *argv])


def _reference_weights(arch):
    jcfg = j_smoke(arch)
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_smoke_config(arch), device="cpu")
    return jcfg, jparams, params


def test_serve_lm_mole_off_matches_reference_and_mole_token(capsys):
    """``tests/test_lm_engine.py::test_serve_lm_engine_matches_plain_serving``
    across the packages: ``serve --mode lm --mole off`` on the CPU with the
    reference's weights serves the raw model on the raw prompts, one group,
    no registry, engine or kernel; its generations equal the reference
    launcher's ``--mole off``, and the port's ``--mole token`` at 1 and 2
    tenants equal them, token for token wherever the reference's top-2 gap
    decides (:func:`_lm_parity.hold_lane`)."""
    flags = ["--mode", "lm", "--arch", "deepseek_7b", "--smoke",
             "--requests", "4", "--prompt-len", "16", "--gen", "4"]
    want = np.asarray(jserve.main([*flags, "--mole", "off"]))
    ref_out = capsys.readouterr().out
    jcfg, jparams, params = _reference_weights("deepseek_7b")
    prompts = np.asarray(SyntheticLM(DataConfig(
        vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0)).batch(0)["tokens"])
    before = grouped_row_gemm.launches
    off = tserve.run_lm(tserve.parse_args([*flags, "--mole", "off",
                                           "--device", "cpu"]), params=params)
    port_out = capsys.readouterr().out
    assert grouped_row_gemm.launches == before
    assert off.shape == (4, 4) and off.dtype == np.int64
    assert hold_lane(jparams, jcfg, prompts, off, want) > 0
    assert "mole=off device=cpu" in port_out and "engine morph" not in port_out
    for out, gens in ((ref_out, want), (port_out, off)):
        line = f"first request generation (provider view): {gens[0][:12].tolist()}"
        assert line in out.splitlines()
    for tenants in ("1", "2"):
        mole = tserve.run_lm(tserve.parse_args(
            [*flags, "--mole", "token", "--tenants", tenants, "--device", "cpu"]),
            params=params)
        assert hold_lane(jparams, jcfg, prompts, mole, off) > 0


@pytest.mark.parametrize("arch", ["deepseek_7b", "phi3_mini_3p8b"])
def test_serve_lm_smoke_matches_reference_cli(capsys, arch):
    """``serve --mode lm --smoke --device cpu`` with the reference's weights:
    the same generations as the reference launcher, and the first one
    printed the same way; the CPU run launches no kernel."""
    flags = ["--mode", "lm", "--arch", arch, "--smoke",
             "--requests", "6", "--tenants", "3", "--prompt-len", "8",
             "--gen", "5"]
    want = jserve.main([*flags, "--backend", "jnp"])
    ref_out = capsys.readouterr().out
    args = tserve.parse_args([*flags, "--device", "cpu"])
    _, _, params = _reference_weights(arch)
    before = grouped_row_gemm.launches
    got = tserve.run_lm(args, params=params)
    port_out = capsys.readouterr().out
    assert grouped_row_gemm.launches == before
    np.testing.assert_array_equal(got, np.asarray(want))
    first = [ln for ln in ref_out.splitlines() if ln.startswith("first")]
    assert first and first[0] in port_out
    assert "engine morph:" in port_out


def test_fair_admission_matches_reference():
    """The copied WFQ admission queue takes sequences in the reference's
    order under 2:1 weights and mixed priorities."""
    orders = []
    for mod in (jrt, trt):
        q = mod.FairAdmissionQueue()
        for i in range(12):
            q.submit("heavy", np.zeros(2, np.int32), 4, weight=2.0,
                     priority=i % 2)
            q.submit("light", np.zeros(2, np.int32), 4 + i % 3, weight=1.0)
        orders.append([(s.tenant_id, s.seq_id) for s in iter(q.take, None)])
    assert orders[0] == orders[1]


# -- the head stacks' storage type (bf16 models stage bf16 Aug-heads) --------

BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")


class _Fp32Heads(trt.ContinuousDecodeLane):
    """The lane with its Aug-head and AugE stacks held in the registry's
    fp32, as they were staged before the stacks took the model's activation
    type."""

    def _refresh_plan(self):
        reg = self.registry
        self._plan = _sync_plan(
            self._plan, reg, {"aug_embeds": reg.slot_aug_embedding,
                              "aug_heads": reg.slot_aug_head}, self.device)
        return self._plan


class _Fp32Embeds(trt.ContinuousDecodeLane):
    """The lane with its AugE stack held in the registry's fp32 and its
    Aug-head stack in the model's activation type (the staging before the
    AugE tables took it too)."""

    def _refresh_plan(self):
        reg = self.registry
        self._plan = _sync_plan(
            self._plan, reg, {"aug_embeds": reg.slot_aug_embedding,
                              "aug_heads": reg.slot_aug_head}, self.device,
            {"aug_heads": self.model.cfg.adtype})
        return self._plan


@pytest.fixture(scope="module")
def lm16():
    """The ``deepseek_7b`` smoke model in bf16 (the port's seeded init) and
    a registry of its tenants, whose secrets are fused from its weights."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), **BF16)
    model = Model(cfg, "cpu")
    params = model.init(0)
    embed = params["embed"].float().numpy()
    head = params["head"].float().numpy()

    def registry(capacity=TENANTS):
        reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=capacity)
        for i in range(TENANTS):
            reg.register(f"t{i}", embed, seed=100 + i, head=head)
        return reg

    return model, params, registry


def test_bf16_lane_stages_bf16_heads(lm16):
    """A bf16 model's lane stages its Aug-heads and its AugE tables in bf16,
    each slot the registry's fp32 table rounded to bf16 (torch's cast,
    nearest even), while the registry keeps fp32; also after an eviction
    patches one slot of the stacks in place."""
    model, params, registry = lm16
    reg = registry(capacity=3)
    lane = trt.ContinuousDecodeLane(model, params, reg, rows=2,
                                    max_len=MAX_LEN, device="cpu")
    for step in range(2):
        plan = lane._refresh_plan()
        heads, embeds = plan.arrays["aug_heads"], plan.arrays["aug_embeds"]
        assert heads.dtype == torch.bfloat16 == embeds.dtype
        want = torch.from_numpy(reg.stacked_aug_heads())
        assert torch.equal(heads, want.bfloat16())
        fp32 = np.stack([reg.slot_aug_embedding(s)
                         for s in range(reg.capacity)])
        assert fp32.dtype == np.float32
        assert torch.equal(embeds, torch.from_numpy(fp32).bfloat16())
        if step == 0:
            evictions = reg.evictions
            reg.slot_for("t0")      # not resident: evicts a slot, patched below
            assert reg.evictions == evictions + 1


def _step_logits(monkeypatch, lane, lm16_prompts, gens):
    """Every batched decode step's logits (as the lane's step computed
    them) and the generations, for one run with joins and retirements."""
    import repro_torch.launch.steps as steps

    seen, real = [], steps.lm_head_rows_grouped
    monkeypatch.setattr(steps, "lm_head_rows_grouped",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    sids = [lane.submit(f"t{i}", p, g) for i, (p, g)
            in enumerate(zip(lm16_prompts, gens))]
    lane.run()
    monkeypatch.undo()
    return seen, [lane.take(s) for s in sids]


def test_bf16_heads_give_the_fp32_heads_logits_bit_for_bit(lm16, monkeypatch):
    """In a bf16 model every decode step's logits, and every generation, are
    the same bits with the bf16 Aug-head stacks as with fp32 stacks: K3
    (and the admission prefill) round each fp32 entry to bf16 before the
    product, which is what the stack's cast does."""
    model, params, registry = lm16
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(5)]
    gens = GENS[:5]
    runs = []
    for cls in (trt.ContinuousDecodeLane, _Fp32Heads):
        lane = cls(model, params, registry(), rows=2, max_len=MAX_LEN,
                   device="cpu")
        runs.append(_step_logits(monkeypatch, lane, prompts, gens))
        assert lane._plan.arrays["aug_heads"].dtype == (
            torch.float32 if cls is _Fp32Heads else torch.bfloat16)
    (l16, g16), (l32, g32) = runs
    assert len(l16) == len(l32) >= max(gens) - 1
    for a, b in zip(l16, l32):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(g16, g32):
        np.testing.assert_array_equal(a, b)


def test_fp32_model_keeps_fp32_heads(lm):
    """An fp32 model (every smoke config) stages fp32 Aug-heads, equal to
    the registry's."""
    lane = lm.lane(rows=2)
    plan = lane._refresh_plan()
    heads = plan.arrays["aug_heads"]
    assert heads.dtype == torch.float32 == lm.cfg.adtype
    assert torch.equal(heads, torch.from_numpy(
        lane.registry.stacked_aug_heads()))


def test_bf16_aug_embeds_give_the_fp32_tables_tokens_and_logits(lm16,
                                                                 monkeypatch):
    """In a bf16 model every decode step's logits and every generation are
    the same bits with bf16 AugE stacks as with fp32 ones (the heads bf16
    in both): each gathered AugE row is cast to bf16 before the trunk reads
    it, which is what the stack's cast does, row for row."""
    model, params, registry = lm16
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, model.cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(5)]
    gens = GENS[:5]
    runs = []
    for cls in (trt.ContinuousDecodeLane, _Fp32Embeds):
        lane = cls(model, params, registry(), rows=2, max_len=MAX_LEN,
                   device="cpu")
        runs.append(_step_logits(monkeypatch, lane, prompts, gens))
        assert lane._plan.arrays["aug_embeds"].dtype == (
            torch.float32 if cls is _Fp32Embeds else torch.bfloat16)
        assert lane._plan.arrays["aug_heads"].dtype == torch.bfloat16
    (l16, g16), (l32, g32) = runs
    assert len(l16) == len(l32) >= max(gens) - 1
    for a, b in zip(l16, l32):
        assert torch.equal(a, b)
    for a, b in zip(g16, g32):
        np.testing.assert_array_equal(a, b)
