"""The port's train step, pipeline and launchers for the audio
encoder-decoder (``whisper_tiny``) on the CPU against the JAX reference, at
the smoke config: ``make_train_step`` (2 microbatches of tokens, targets and
frames, remat), ``_split_micro`` on frames, ``launch/train.py`` under each
``--mole`` and a ``--resume`` through the nested checkpoint tree, and
``serve --mode lm`` (``--mole token``, one tenant at a time on fused
params, and ``--mole off``).  The set-up and tolerances are
``test_torch_whisper.py``'s (``_whisper_parity.py``): the train step's
gradients, moments and grad_norm at ``oracle_tol`` of the float64
evaluation, its parameters within ``tests/test_torch_train.py``'s
Adam-step bound (``_vlm_parity.hold_update``); generations under
``_lm_parity.hold_lane``'s tie-margin rule, on the reference's own
all-zero frames.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _lm_parity import hold_lane  # noqa: E402
from _vlm_parity import (  # noqa: E402
    LOSS_RTOL, close_to, grad_tols, hold_update, j_batch, leaves, t_batch,
)
from _whisper_parity import ARCH, make_ref  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import TrainHParams as JTrainHParams  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint.manager import tree_leaves  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return make_ref()


def test_train_step_matches_reference(ref):
    """``make_train_step`` (2 microbatches, remat) against the reference's
    jitted step: loss, grad_norm, lr, both moments (``enc_proj`` and the
    encoder blocks among them), and the parameters within
    ``hold_update``'s bound of the reference's."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    jmodel = JModel(jcfg)
    batch = dict(ref["batch"])
    hp = dict(microbatch=2, remat=True)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainHParams(
        optimizer=jadamw.AdamWConfig(warmup_steps=2), **hp)))
    want_p, want_opt, want_m = jstep(
        ref["jparams"], jadamw.init_state(ref["jparams"]), j_batch(batch))
    _, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, j_batch(batch))))(ref["jparams"])
    params = params_from_jax(ref["np"], cfg, "cpu")
    before = {n: p.detach().clone() for n, p in adamw.named_leaves(params)}
    step = make_train_step(Model(cfg, "cpu"), TrainHParams(
        optimizer=adamw.AdamWConfig(warmup_steps=2), **hp))
    _, opt, m = step(params, adamw.init_state(params), t_batch(batch))
    assert int(opt["count"]) == 1
    assert {"enc_proj", "enc_blocks.1.ffn.wo", "dec.blocks.0.cross.wv"} <= set(
        opt["m"])
    grad_tol, norm_tol = grad_tols(ref, leaves(jg, cfg),
                                    float(want_m["grad_norm"]))
    for k, rel in (("loss", LOSS_RTOL), ("grad_norm", norm_tol),
                   ("lr", LOSS_RTOL)):
        assert float(m[k]) == pytest.approx(float(want_m[k]), rel=rel), k
    for key, tol in (("m", grad_tol), ("v", 2 * grad_tol)):
        want = leaves(want_opt[key], cfg)
        assert sorted(opt[key]) == sorted(want)
        for name, got in opt[key].items():
            close_to(got, want[name], tol, f"{key} {name}")
    want, grads = leaves(want_p, cfg), leaves(jg, cfg)
    lr = float(want_m["lr"])
    scale = min(1.0, adamw.AdamWConfig().clip_norm / float(want_m["grad_norm"]))
    for name, p in adamw.named_leaves(params):
        assert not p.requires_grad
        hold_update(name, p.detach(), want[name], before[name], grads[name],
                    lr, grad_tol, scale)


def test_split_micro_splits_frames(ref):
    """Every input of a batch, the frames included, is cut along its first
    axis into the microbatches the train step sums over."""
    batch = t_batch(ref["batch"])
    micro = steps._split_micro(batch, 2)
    assert sorted(micro) == ["frames", "targets", "tokens"]
    fe = ref["cfg"].frontend
    assert tuple(micro["frames"].shape) == (2, 1, fe.n_tokens, fe.d_in)
    for k, x in batch.items():
        for i in range(2):
            assert torch.equal(micro[k][i], x[i:i + 1])


# -- the launchers ----------------------------------------------------------

def _shape_of(out: str) -> list[str]:
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in out.splitlines()]


@pytest.mark.parametrize("mole", ["off", "token", "embedding"])
def test_train_main_prints_the_reference_format(tmp_path, capsys, mole):
    """``launch/train.py --arch whisper_tiny --smoke --mole <mole>`` (kappa
    4 in embedding mode) through the reference's ``main`` and the port's
    (``--device cpu``): the same header word for word, the same lines with
    the numbers taken out, finite losses."""
    argv = ["--arch", ARCH, "--smoke", "--mole", mole, "--kappa", "4",
            "--seq-len", "16", "--batch", "2", "--steps", "2",
            "--ckpt-every", "2", "--log-every", "1"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    _, hist = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    head = [line for line in want.splitlines() if line.startswith("arch=")]
    assert head == [line for line in got.splitlines()
                    if line.startswith("arch=")]
    assert f"mole={mole}" in head[0] and "params=0.23M" in head[0]
    losses = [float(h["loss"]) for h in hist if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_main_resume_is_bit_for_bit(tmp_path, capsys):
    """``--mole embedding``: a run cut after 2 steps and resumed to 4 ends
    with the clean 4-step run's parameters (the nested encoder and decoder
    trees) and moments bit for bit, its losses at steps 2-3 equal."""
    flags = ["--arch", ARCH, "--smoke", "--mole", "embedding", "--kappa", "4",
             "--device", "cpu", "--seq-len", "16", "--batch", "4",
             "--microbatch", "2", "--warmup", "4", "--ckpt-every", "2",
             "--log-every", "1"]
    clean, clean_hist = train.main(flags + ["--steps", "4", "--ckpt-dir",
                                            str(tmp_path / "clean")])
    train.main(flags + ["--steps", "2", "--ckpt-dir", str(tmp_path / "cut")])
    resumed, hist = train.main(flags + ["--steps", "4", "--resume",
                                        "--ckpt-dir", str(tmp_path / "cut")])
    assert "resumed from step 2" in capsys.readouterr().out

    def losses(h):
        return {x["step"]: float(x["loss"]) for x in h if "loss" in x}

    assert sorted(losses(hist)) == [2, 3]
    assert all(losses(hist)[s] == losses(clean_hist)[s] for s in (2, 3))
    got, want = tree_leaves(resumed), tree_leaves(clean)
    names = [n for n, _ in adamw.named_leaves(clean["params"])]
    assert "enc_blocks.1.mix.wq" in names and "dec.blocks.1.cross.wo" in names
    assert len(got) == len(want) > len(names)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(resumed["opt"]["count"]) == 4


@pytest.mark.parametrize("mole", ["token", "off"])
def test_serve_lm_matches_reference(mole, capsys):
    """``serve --mode lm --arch whisper_tiny --smoke``: the reference's
    ``run_lm`` (its own weights from the seed, all-zero frames) against the
    port's on those weights carried over; with ``--mole token`` (2 tenants
    of 2 requests) one tenant at a time on fused params, unmorphed by the
    provider.  Held under ``_lm_parity``'s tie-margin rule against a
    teacher-forced reference forward on the same zero frames."""
    argv = ["--mode", "lm", "--arch", ARCH, "--smoke", "--requests", "4",
            "--prompt-len", "8", "--gen", "4", "--mole", mole]
    if mole == "token":
        argv += ["--tenants", "2"]      # two requests a tenant
    want = np.asarray(jserve.main(argv))
    jcfg = j_smoke(ARCH)
    jparams = JModel(jcfg).init(jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    args = serve.parse_args(argv + ["--device", "cpu"])
    got = serve.run_lm(args, params=params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu"))
    out = capsys.readouterr().out
    assert got.shape == want.shape == (4, 4)
    assert f"mole={mole}" in out
    prompts = np.asarray(JSyntheticLM(JDataConfig(
        vocab=cfg.vocab, seq_len=8, global_batch=4, seed=0)).batch(0)["tokens"])
    zeros = jnp.zeros((4, cfg.frontend.n_tokens, cfg.frontend.d_in))
    hold_lane(jparams, jcfg, list(prompts), list(got), list(want), ctx=zeros)
