"""The port's decode lane and ``serve --mode lm`` at the ``gemma2_27b`` and
``command_r_35b`` smoke configs against the JAX reference's.

Both packages get the same weights (``params_from_jax``) and the same
tenants (a reference ``LMSessionRegistry`` restored into the port's).  The
gemma2 smoke window is 8 positions: prompts of 8 and 16 tokens with up to 8
generated wrap every local layer's ring, in the prefill and in the decode
steps, and rows retire and re-join.  Generations are held token for token
wherever the reference's top-2 gap decides (``_lm_parity.hold_lane``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.lm as jlm  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
import repro_torch.core.lm as tlm  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import grouped_row_gemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from _lm_parity import hold_lane  # noqa: E402

ARCHS = ["gemma2_27b", "command_r_35b"]
PROMPT_LEN, MAX_LEN = 8, 24
TENANTS = 6
GENS = [3, 8, 4, 7, 2, 6]


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """The smoke model of one arch in both packages, tenants registered in
    the reference's registry, and the reference lane's generations for one
    traffic set on 3 rows (rows retire and re-join)."""
    arch = request.param
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).astype(np.int32)
               for _ in range(TENANTS)]
    jreg = jlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=TENANTS)
    for i in range(TENANTS):
        # tied embeddings: no head, both decode with AugE.T
        jreg.register(f"t{i}", np_params["embed"], seed=100 + i)
    lane = jrt.ContinuousDecodeLane(jmodel, jparams, jreg, rows=3,
                                    max_len=MAX_LEN)
    sids = [lane.submit(f"t{i}", prompts[i], GENS[i]) for i in range(TENANTS)]
    lane.run()
    return {
        "arch": arch, "jcfg": jcfg, "cfg": cfg, "jparams": jparams,
        "params": params_from_jax(np_params, cfg, device="cpu"),
        "prompts": prompts, "snapshot": jreg.snapshot_state(),
        "want": [np.asarray(lane.take(s)) for s in sids],
    }


def _lane(lm, rows):
    reg = tlm.LMSessionRegistry(lm["cfg"].vocab, lm["cfg"].d_model,
                                capacity=TENANTS)
    reg.restore_state(*lm["snapshot"])
    return trt.ContinuousDecodeLane(Model(lm["cfg"], "cpu"), lm["params"],
                                    reg, rows=rows, max_len=MAX_LEN,
                                    device="cpu")


@pytest.mark.parametrize("rows", [3, 2])
def test_lane_matches_reference_lane(lm, rows):
    """The port's lane over the same traffic (on the reference's 3 rows, and
    on 2, so other rows are re-admitted after their rings wrapped): every
    generation held to the reference lane's, and the lane's Aug-head stack
    is the registry's tied head, AugE.T."""
    lane = _lane(lm, rows)
    sids = [lane.submit(f"t{i}", lm["prompts"][i], GENS[i])
            for i in range(TENANTS)]
    lane.run()
    got = [lane.take(s) for s in sids]
    assert hold_lane(lm["jparams"], lm["jcfg"], lm["prompts"], got,
                     lm["want"]) > 0
    reg = lane.registry
    assert np.array_equal(reg.slot_aug_head(0), reg.slot_aug_embedding(0).T)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_matches_reference_cli(capsys, arch):
    """``serve --mode lm --smoke`` on the CPU with the reference's weights:
    ``--mole off`` against the reference launcher's ``--mole off``, and
    ``--mole token`` at 1 and 2 tenants against it, each held token for
    token where the reference decides; 16-token prompts and 4 generated
    tokens, so gemma2's window of 8 wraps.  The CPU launches no kernel."""
    flags = ["--mode", "lm", "--arch", arch, "--smoke", "--requests", "4",
             "--prompt-len", "16", "--gen", "4"]
    want = np.asarray(jserve.main([*flags, "--mole", "off"]))
    ref_out = capsys.readouterr().out
    jcfg = j_smoke(arch)
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_smoke_config(arch), device="cpu")
    prompts = np.asarray(SyntheticLM(DataConfig(
        vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=0)).batch(0)["tokens"])
    before = grouped_row_gemm.launches
    off = tserve.run_lm(tserve.parse_args([*flags, "--mole", "off",
                                           "--device", "cpu"]), params=params)
    assert off.shape == (4, 4) == want.shape
    assert hold_lane(jparams, jcfg, prompts, off, want) > 0
    assert f"arch={arch}" in ref_out
    for tenants in ("1", "2"):
        mole = tserve.run_lm(tserve.parse_args(
            [*flags, "--mole", "token", "--tenants", tenants,
             "--device", "cpu"]), params=params)
        assert hold_lane(jparams, jcfg, prompts, mole, want) > 0
    assert grouped_row_gemm.launches == before
    assert "mole=token device=cpu" in capsys.readouterr().out


def test_tied_heads_are_the_staged_tables_transposed():
    """The gemma2 smoke model in bf16 with capacity 3 for 4 tenants, one of
    them registered with a head of its own: the lane stages each tied
    slot's Aug-head as its AugE stack transposed on the device, the untied
    slot's from the registry, all equal to the registry's fp32 heads cast
    to bf16; also after an eviction patches one slot in place."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("gemma2_27b"),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(0)
    embed = params["embed"].float().numpy()
    head = np.random.default_rng(2).standard_normal(
        (cfg.d_model, cfg.vocab)).astype(np.float32)
    reg = tlm.LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=3)
    for i in range(4):
        reg.register(f"t{i}", embed, seed=i, head=head if i == 1 else None)
    lane = trt.ContinuousDecodeLane(model, params, reg, rows=2, max_len=16,
                                    device="cpu")
    for step in range(2):
        plan = lane._refresh_plan()
        heads = plan.arrays["aug_heads"]
        assert heads.dtype == torch.bfloat16
        assert torch.equal(heads,
                           torch.from_numpy(reg.stacked_aug_heads()).bfloat16())
        untied = [s for s in range(reg.capacity) if not reg.slot_head_tied(s)]
        assert untied == ([reg.slot_for("t1")] if step == 0 else [])
        if step == 0:
            evictions = reg.evictions
            for t in ("t0", "t2", "t3"):    # evict t1; t0 takes a slot back
                reg.slot_for(t)
            assert reg.evictions > evictions
