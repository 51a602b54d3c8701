"""The port's sharding on several CPU ranks (gloo), as the reference's
``tests/test_distributed.py`` runs on 8 fake CPU devices:

  * the train step on a (2, 2, 2) pod/data/model mesh against the port's
    unsharded step (loss, grad norm, every gradient leaf) and against the
    reference's step on the same parameters and batch;
  * ``compressed_psum`` over the pod axis within the int8 tolerance, int8
    on the wire;
  * the delivery engine's group axis over an (8, 1) mesh, its flushed
    images against the reference's per-request ``deliver``, and its token
    and features lanes, sharded against unsharded;
  * expert-parallel MoE on a (2, 2) mesh against the reference's per-shard
    reconstruction (``_moe_local_tokens`` on each shard, summed over
    "model"), output and gradient, and the deepseek_moe_16b train step
    through it against its unsharded step and against the reference's
    step with that reconstruction in place of its MoE FFN.

Two spawned jobs (``tests/_torch_dist_ranks.py``: 8 ranks, then 4), each
run once for the module; each process group has its own timeout and each
join a deadline.  The parent computes the reference's side (JAX, on the
same parameters, written for the ranks before they start) while the ranks
run.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_ranks as ranks  # noqa: E402

TRAIN_REL = 1e-5        # loss and grad norm, relative
GRAD_REL = 1e-5         # each gradient leaf, of its max|g|
# Each gradient leaf against the reference's, of its max|g|: the port's
# bound for its unsharded step against the reference
# (tests/test_torch_train.py GRAD_TOL: two fp32 implementations of the
# same step; unsharded, the deepseek_7b smoke step here differs by 2.0e-5,
# at the embedding).
REF_GRAD_REL = 1e-4
REF_LOSS_ABS = 1e-3     # the reference's bounds, test_distributed.py:77-78
REF_PARAM_ABS = 5e-3
PSUM_ABS = 0.05         # test_distributed.py:95
DELIVERY_ABS = 1e-5     # test_distributed.py:170
MOE_REL = 1e-5          # of max|reconstruction|


def _jax_model(arch: str):
    """The reference's model at the smoke config in fp32, and its
    parameters from a seed."""
    import jax

    from repro.configs import get_smoke_config
    from repro.models.api import Model as JModel

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    jm = JModel(cfg)
    return jm, jax.jit(jm.init)(jax.random.key(0))


def _port_named(tree, arch: str) -> dict:
    """A tree in the reference's layout (parameters or gradients) as the
    port's leaves, by ``adamw.named_leaves`` name."""
    import jax

    from repro_torch.models import params_from_jax
    from repro_torch.optim import adamw

    pt = params_from_jax(jax.tree.map(np.asarray, tree),
                         ranks.train_cfg(arch), "cpu")
    return {n: p.numpy() for n, p in adamw.named_leaves(pt)}


def _ep_moe(dp: int, mp: int):
    """The reference's expert parallelism rebuilt shard by shard in JAX, as
    a stand-in for its ``apply_moe``: ``_moe_local_tokens`` on each (dp,
    model) shard's tokens and experts, the shared experts row-parallel,
    summed over the model shards."""
    import jax.numpy as jnp

    from repro.models import blocks as JB
    from repro.models import layers as JL

    def moe(p, x, cfg):
        m = cfg.moe
        nl, fs = m.n_routed // mp, m.n_shared * m.d_ff_expert // mp
        B, S, d = x.shape
        rows = []
        for i in range(dp):
            xf = x[i * B // dp:(i + 1) * B // dp].reshape(-1, d)
            y = 0.0
            for j in range(mp):
                loc = {"router": p["router"],
                       **{k: p[k][j * nl:(j + 1) * nl]
                          for k in ("wg", "wu", "wd")}}
                yj = JB._moe_local_tokens(loc, xf, cfg, j * nl, nl)
                if m.n_shared:
                    sp, cols = p["shared"], slice(j * fs, (j + 1) * fs)
                    g = JL.act_fn(cfg.act)(xf @ sp["wi_gate"][:, cols])
                    yj = yj + (g * (xf @ sp["wi_up"][:, cols])) @ sp["wo"][cols]
                y = y + yj
            rows.append(y.reshape(-1, S, d))
        return jnp.concatenate(rows)

    return moe


def _reference_step(jm, jp, arch: str, shape, microbatch, moe=None):
    """The reference's train step (``make_train_step``, jitted) on
    ``ranks.train_batch``: its loss, grad norm and the gradients AdamW
    received (port names), with ``moe`` in place of its ``apply_moe``
    where given."""
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import TrainHParams, make_train_step
    from repro.models import blocks as JB
    from repro.optim import adamw as jadamw

    step = make_train_step(jm, TrainHParams(microbatch=microbatch))
    real_apply, real_moe = jadamw.apply, JB.apply_moe

    def run(p, b):
        seen = {}

        def capture(cfg, params, grads, state):
            seen["g"] = grads
            return real_apply(cfg, params, grads, state)

        jadamw.apply = capture
        JB.apply_moe = moe or real_moe
        try:
            _, _, m = step(p, jadamw.init_state(p), b)
        finally:
            jadamw.apply, JB.apply_moe = real_apply, real_moe
        return m["loss"], m["grad_norm"], seen["g"]

    batch = {k: jnp.asarray(v)
             for k, v in ranks.train_batch(jm.cfg.vocab, shape).items()}
    loss, gnorm, grads = jax.jit(run)(jp, batch)
    return {"loss": float(loss), "gnorm": float(gnorm),
            "grads": _port_named(grads, arch)}


def _reference_images() -> dict:
    """The reference's per-request ``deliver`` of each tenant's images, on
    the registry and data the ranks build (same seeds)."""
    import jax.numpy as jnp

    import repro.core as jcore

    rng = np.random.default_rng(0)
    geom, reg = ranks.vision_registry(jcore, rng)
    datas = ranks.engine_inputs(rng, geom, reg.tenant_ids)
    return {t: np.asarray(reg.session(t).deliver(jnp.asarray(d)))
            for t, d in datas.items()}


def _load(path) -> dict:
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs started together (8 ranks and 4), with the reference's
    side computed in this process while they run; each job's result, or
    the error that ended it."""
    from repro_torch.configs import get_smoke_config

    moe = "deepseek_moe_16b"
    paths = {"job8": tmp_path_factory.mktemp("job8"),
             "job4": tmp_path_factory.mktemp("job4")}
    handles = {"job8": ranks.start("job8", 8, paths["job8"]),
               "job4": ranks.start("job4", 4, paths["job4"])}
    out = {}
    try:
        # the ranks wait for these before their train steps
        jm8, jp8 = _jax_model("deepseek_7b")
        jm4, jp4 = _jax_model(moe)
        ranks.save_params(paths["job8"] / ranks.TRAIN_PARAMS,
                          _port_named(jp8, "deepseek_7b"))
        ranks.save_params(paths["job4"] / ranks.MOE_TRAIN_PARAMS,
                          _port_named(jp4, moe))
        refs = {
            "job8": {"train": _reference_step(jm8, jp8, "deepseek_7b",
                                              ranks.TRAIN_BATCH, 2),
                     "images": _reference_images()},
            "job4": {
                "layer": _reference_moe(ranks.moe_arrays(
                    get_smoke_config(moe))),
                "train": _reference_step(jm4, jp4, moe,
                                         ranks.MOE_TRAIN_BATCH, 2,
                                         moe=_ep_moe(2, 2)),
                # 3 rows do not split over dp = 2: the reference's dense
                # form
                "odd": _reference_step(jm4, jp4, moe,
                                       ranks.MOE_ODD_TRAIN_BATCH, None)},
        }
    finally:
        for job, handle in handles.items():
            try:
                out[job] = types.SimpleNamespace(records=handle.join(),
                                                 path=paths[job])
            except Exception as e:      # noqa: BLE001 - raised per job
                out[job] = e
    for job, ns in out.items():
        if not isinstance(ns, Exception):
            ns.ref = refs[job]
    return out


def _job(jobs, name: str):
    got = jobs[name]
    if isinstance(got, Exception):
        raise got
    return got


@pytest.fixture(scope="module")
def job8(jobs):
    out = _job(jobs, "job8")
    out.grads = _load(out.path / "job8_grads.npz")
    out.images = _load(out.path / "job8_images.npz")
    return out


@pytest.fixture(scope="module")
def job4(jobs):
    out = _job(jobs, "job4")
    out.arrays = _load(out.path / "job4_arrays.npz")
    out.grads = _load(out.path / "job4_train_grads.npz")
    return out


def _worst(got: dict, want: dict):
    return max(((n, float(np.max(np.abs(got[n] - w)) / np.max(np.abs(w))))
                for n, w in want.items()), key=lambda kv: kv[1])


def test_sharded_train_step_matches_single_device(job8):
    """deepseek_7b smoke (fp32), batch (8, 32), microbatch=2, on 8 ranks
    (2, 2, 2), against the port's unsharded step on the same rank."""
    for r, rec in enumerate(job8.records):
        t = rec["train"]
        worst = max(t["grad_rel"].items(), key=lambda kv: kv[1])
        print(f"rank {r}: loss {t['loss_sh']!r} vs {t['loss_ref']!r} "
              f"(limit {TRAIN_REL} rel), grad norm {t['gnorm_sh']!r} vs "
              f"{t['gnorm_ref']!r}, worst leaf {worst[0]} {worst[1]:.3e} of "
              f"its max|g| (limit {GRAD_REL}), params {t['param_err']:.3e} "
              f"(limit {REF_PARAM_ABS})")
        loss_err = abs(t["loss_sh"] - t["loss_ref"])
        assert loss_err <= TRAIN_REL * abs(t["loss_ref"])
        assert abs(t["gnorm_sh"] - t["gnorm_ref"]) <= (TRAIN_REL
                                                       * t["gnorm_ref"])
        assert worst[1] <= GRAD_REL, worst
        assert t["param_err"] < REF_PARAM_ABS
        assert t["metrics_plain"] and t["leaves_dtensor"]
        assert t["moments_like_leaves"]
        # head (d, V): embed over ("pod", "data"), vocab over "model"
        assert t["head_placements"] == ["S(0)", "S(0)", "S(1)"], t


def test_sharded_train_step_matches_the_reference(job8):
    """The same sharded step against the reference's step (JAX, unsharded)
    on the same parameters and batch: loss and grad norm within 1e-5
    relative, the loss within the reference's own 1e-3, every gradient
    leaf within REF_GRAD_REL of its max|g|."""
    want = job8.ref["train"]
    for r, rec in enumerate(job8.records):
        t = rec["train"]
        print(f"rank {r}: loss {t['loss_sh']!r} vs the reference's "
              f"{want['loss']!r}, grad norm {t['gnorm_sh']!r} vs "
              f"{want['gnorm']!r} (limit {TRAIN_REL} rel)")
        assert abs(t["loss_sh"] - want["loss"]) <= TRAIN_REL * abs(
            want["loss"])
        assert abs(t["loss_sh"] - want["loss"]) < REF_LOSS_ABS
        assert abs(t["gnorm_sh"] - want["gnorm"]) <= TRAIN_REL * want["gnorm"]
    worst = _worst(job8.grads, want["grads"])
    print(f"worst gradient leaf against the reference: {worst[0]} "
          f"{worst[1]:.3e} of its max|g| (limit {REF_GRAD_REL})")
    assert set(job8.grads) == set(want["grads"])
    assert worst[1] <= REF_GRAD_REL, worst


def test_every_rank_computes_the_same_step(job8):
    losses = {rec["train"]["loss_sh"] for rec in job8.records}
    norms = {rec["train"]["gnorm_sh"] for rec in job8.records}
    assert len(losses) == 1 and len(norms) == 1, (losses, norms)


def test_compressed_psum_matches_psum(job8):
    for rec in job8.records:
        p = rec["psum"]
        print(f"compressed_psum err {p['err']:.4f} (limit {PSUM_ABS}), "
              f"wire {p['wire']}")
        assert p["err"] < PSUM_ABS, p
        assert p["wire"] == ["torch.int8", "torch.float32"], p
        assert p["dtype"] == "torch.float32"


def test_nested_shards_split_pod_major(job8):
    """A dim on ("pod", "data") is split as JAX splits it: shard index
    pod * n_data + data."""
    for rec in job8.records:
        assert rec["order"]["ok"], rec["order"]
        assert rec["order"]["placements"] == ["S(0)", "S(0)", "S(1)"]


def test_hint_redistributes_dtensors_under_a_mesh(job8):
    for rec in job8.records:
        h = rec["hint"]
        assert h["both"] == ["S(0)", "S(0)", "S(1)"] and h["both_value"], h
        assert h["odd"] == ["R", "S(1)", "S(0)"], h
        assert h["absent"] == ["S(0)", "S(0)", "R"], h
        # 6 rows do not split over the 4 dp ranks; 3 columns not over 2
        assert h["undivided"] == ["R", "R", "R"], h
        assert h["plain"] and h["no_mesh"], h


def test_delivery_engine_shards_group_axis_across_ranks(job8):
    """tests/test_distributed.py:99 on 8 gloo ranks: the microbatch of 8
    tenants is Shard(0) over "data", one group a rank, and the flushed
    results match the per-request path."""
    coords = set()
    for rec in job8.records:
        v = rec["engine"]["vision"]
        print(f"rank {v['coord']}: {v['placements']} local "
              f"{v['local_shape']}, err {v['err']:.3e} (limit {DELIVERY_ABS})")
        assert v["dtensor"] and v["placements"] == ["S(0)", "R"], v
        assert v["shape"][0] == 8
        assert v["local_shape"] == [1] + v["shape"][1:], v
        assert v["err"] < DELIVERY_ABS, v
        coords.add(v["coord"])
    assert coords == set(range(8))


def test_delivery_engine_group_axis_matches_the_reference_deliver(job8):
    """The images the sharded engine flushed against the reference's
    per-request ``deliver`` on the same registry seeds and data
    (tests/test_distributed.py:164-170)."""
    want = job8.ref["images"]
    assert set(job8.images) == set(want)
    err = max(float(np.max(np.abs(job8.images[t] - w)))
              for t, w in want.items())
    print(f"flushed images against the reference's deliver: {err:.3e} "
          f"(limit {DELIVERY_ABS})")
    assert err < DELIVERY_ABS


def test_token_and_features_lanes_sharded_give_the_same_bits(job8):
    for rec in job8.records:
        lanes = rec["engine"]["lanes"]
        assert lanes["same_bits"] and lanes["tokens_dtensor"], lanes


def _reference_moe(arrays, dp: int = 2, mp: int = 2):
    """One MoE layer through :func:`_ep_moe`, and the gradient of
    sum(y * cot) through it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config

    cfg = get_smoke_config("deepseek_moe_16b")
    p0 = {k: jnp.asarray(arrays[k]) for k in ("router", "wg", "wu", "wd")}
    p0["shared"] = {k: jnp.asarray(arrays[f"shared.{k}"])
                    for k in ("wi_gate", "wi_up", "wo")}
    recon = _ep_moe(dp, mp)
    x = jnp.asarray(arrays["x"])
    cot = jnp.asarray(arrays["cot"])
    y, vjp = jax.vjp(jax.jit(lambda x, p: recon(p, x, cfg)), x, p0)
    gx, gp = vjp(cot)
    grads = {"x": np.asarray(gx),
             **{k: np.asarray(gp[k]) for k in ("router", "wg", "wu", "wd")},
             **{f"shared.{k}": np.asarray(v) for k, v in gp["shared"].items()}}
    return np.asarray(y), grads


def test_expert_parallel_moe_matches_the_per_shard_reconstruction(job4):
    """deepseek_moe_16b smoke on a (2, 2) mesh, each rank on its own tokens
    with the weights placed by the rules and viewed as the train step
    views them: output and gradient within 1e-5 of max against the
    reference's reconstruction."""
    got = job4.arrays
    want_y, want_g = job4.ref["layer"]
    err = float(np.max(np.abs(got["y"] - want_y)) / np.max(np.abs(want_y)))
    print(f"MoE output: {err:.3e} of max (limit {MOE_REL})")
    assert err <= MOE_REL
    for k, w in want_g.items():
        e = float(np.max(np.abs(got[f"grad_{k}"] - w)) / np.max(np.abs(w)))
        print(f"MoE grad {k}: {e:.3e} of max (limit {MOE_REL})")
        assert e <= MOE_REL, k
    for rec in job4.records:
        assert rec["plain"], rec
        assert rec["local_shape"] == [2, 16, 64], rec


# A sharded MoE step's grad norm against the reference's: a norm of the
# gradients, held as they are (unsharded, the port's deepseek_moe_16b smoke
# step differs from the reference's by 1.9e-5 relative on the odd batch).
REF_MOE_NORM_REL = REF_GRAD_REL


def _hold_unsharded(t: dict) -> None:
    """A sharded step's readings against the port's unsharded step's."""
    worst = max(t["grad_rel"].items(), key=lambda kv: kv[1])
    print(f"loss {t['loss_sh']!r} vs unsharded {t['loss_ref']!r}, grad "
          f"norm {t['gnorm_sh']!r} vs {t['gnorm_ref']!r} (limit {TRAIN_REL} "
          f"rel), worst leaf {worst[0]} {worst[1]:.3e} of its max|g| (limit "
          f"{GRAD_REL}), MoE forms {t['forms']}")
    assert abs(t["loss_sh"] - t["loss_ref"]) <= TRAIN_REL * abs(t["loss_ref"])
    assert abs(t["gnorm_sh"] - t["gnorm_ref"]) <= TRAIN_REL * t["gnorm_ref"]
    assert worst[1] <= GRAD_REL, worst


def _hold_reference(t: dict, want: dict, grads: dict | None = None) -> None:
    """A sharded MoE step's readings against the reference's step."""
    print(f"loss {t['loss_sh']!r} vs the reference's {want['loss']!r} "
          f"(limit {TRAIN_REL} rel), grad norm {t['gnorm_sh']!r} vs "
          f"{want['gnorm']!r} (limit {REF_MOE_NORM_REL} rel)")
    assert abs(t["loss_sh"] - want["loss"]) <= TRAIN_REL * abs(want["loss"])
    assert abs(t["gnorm_sh"] - want["gnorm"]) <= (REF_MOE_NORM_REL
                                                  * want["gnorm"])
    if grads is not None:
        assert set(grads) == set(want["grads"])
        w = _worst(grads, want["grads"])
        print(f"worst leaf against the reference: {w[0]} {w[1]:.3e} of its "
              f"max|g| (limit {REF_GRAD_REL})")
        assert w[1] <= REF_GRAD_REL, w


def test_moe_train_step_runs_expert_parallel_and_matches_unsharded(job4):
    """deepseek_moe_16b smoke (fp32), batch (4, 16), microbatch=2, on 4
    ranks (1, 4): each MoE layer takes the expert-parallel form (2 experts
    a rank, every token of the microbatch, so the dense form's capacity),
    and the step matches the port's unsharded step (loss, grad norm, every
    leaf, router and experts included)."""
    for rec in job4.records:
        t = rec["train"]["model4"]
        _hold_unsharded(t)
        assert t["forms"]["sharded"] > 0 and t["forms"]["dense"] == 0, t
        assert {"blocks.1.ffn.router", "blocks.2.ffn.wg",
                "blocks.2.ffn.shared.wo"} <= set(t["grad_rel"])


def test_moe_train_step_sharded_matches_the_reference(job4):
    """The step on (2, 2), each dp rank's row routed with its own capacity
    as the reference's ``shard_map`` routes it, against the reference's
    step with that expert-parallel reconstruction in place of its MoE
    FFN (the unsharded step routes each microbatch's two rows as one call,
    a different capacity)."""
    for rec in job4.records:
        t = rec["train"]["split"]
        assert t["forms"]["sharded"] > 0 and t["forms"]["dense"] == 0, t
        _hold_reference(t, job4.ref["train"], job4.grads)


def test_moe_batch_that_does_not_divide_takes_the_dense_form(job4):
    """3 rows do not split over dp = 2: every rank holds all of them, the
    compute view gathers each MoE FFN whole, and the dense form runs, as
    the reference's dispatcher falls back."""
    for rec in job4.records:
        assert rec["odd_dense_same_bits"] and rec["odd_plain_weights"], rec
        t = rec["train"]["odd"]
        assert t["forms"]["sharded"] == 0 and t["forms"]["dense"] > 0, t
        _hold_unsharded(t)
        _hold_reference(t, job4.ref["odd"])
