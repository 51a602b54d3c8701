"""The port's train step and launchers for the vision-language stack
(``llama32_vision_90b``) on the CPU against the JAX reference, at the smoke
config: ``make_train_step`` (2 microbatches of tokens, targets and patches,
remat), ``launch/train.py --mole embedding`` and ``serve --mode lm``
(``--mole token``, one tenant at a time on fused params, and ``--mole
off``).  The set-up and tolerances are ``test_torch_vlm.py``'s
(``_vlm_parity.py``): the train step's gradients, moments and grad_norm at
``oracle_tol`` of the float64 evaluation, its parameters within
``tests/test_torch_train.py``'s Adam-step bound; generations under
``_lm_parity.hold_lane``'s tie-margin rule.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _lm_parity import hold_lane  # noqa: E402
from _vlm_parity import (  # noqa: E402
    ARCH, LOSS_RTOL, close_to, grad_tols, j_batch, leaves, make_ref, t_batch,
)
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import TrainHParams as JTrainHParams  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import Model, params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return make_ref()


def test_train_step_matches_reference(ref):
    """``make_train_step`` (2 microbatches, remat) against the reference's
    jitted step: loss, grad_norm, lr, both moments, and the parameters
    within 2 lr of the reference's (a gradient entry near zero may take
    the other sign) and within 1e-6 of max|p| + lr where the reference's
    gradient is at least 1e-2 of its max."""
    jcfg, cfg = ref["jcfg"], ref["cfg"]
    jmodel = JModel(jcfg)
    batch = dict(ref["batch"])
    hp = dict(microbatch=2, remat=True)
    jstep = jax.jit(j_make_train_step(jmodel, JTrainHParams(
        optimizer=jadamw.AdamWConfig(warmup_steps=2), **hp)))
    want_p, want_opt, want_m = jstep(
        ref["jparams"], jadamw.init_state(ref["jparams"]), j_batch(batch))
    _, jg = jax.value_and_grad(lambda p: jmodel.loss(p, j_batch(batch)))(
        ref["jparams"])
    params = params_from_jax(ref["np"], cfg, "cpu")
    before = {n: p.detach().clone() for n, p in adamw.named_leaves(params)}
    step = make_train_step(Model(cfg, "cpu"), TrainHParams(
        optimizer=adamw.AdamWConfig(warmup_steps=2), **hp))
    _, opt, m = step(params, adamw.init_state(params), t_batch(batch))
    assert int(opt["count"]) == 1
    grad_tol, norm_tol = grad_tols(ref, leaves(jg, cfg),
                                    float(want_m["grad_norm"]))
    for k, rel in (("loss", LOSS_RTOL), ("grad_norm", norm_tol),
                   ("lr", LOSS_RTOL)):
        assert float(m[k]) == pytest.approx(float(want_m[k]), rel=rel), k
    for key, tol in (("m", grad_tol), ("v", 2 * grad_tol)):
        want = leaves(want_opt[key], cfg)
        for name, got in opt[key].items():
            close_to(got, want[name], tol, f"{key} {name}")
    want, grads = leaves(want_p, cfg), leaves(jg, cfg)
    lr = float(want_m["lr"])
    scale = min(1.0, adamw.AdamWConfig().clip_norm / float(want_m["grad_norm"]))
    for name, p in adamw.named_leaves(params):
        assert not p.requires_grad
        _hold_update(name, p.detach(), want[name], before[name], grads[name],
                     lr, grad_tol, scale)


def _hold_update(name, got, want, before, grad, lr, grad_tol, scale):
    """``tests/test_torch_train.py``'s bound on one Adam step's parameters
    against the reference's.  At t = 1 the step is lr (g s / (|g s| + eps)
    + wd p), s the clip scale: +-lr wherever |g| >> eps.  A gradient entry
    near zero may take the other sign in the other package, which moves
    that entry by up to 2 lr; where |g_ref| >= 1e-2 max|g_ref| the sign is
    decided, and gradients d = grad_tol max|g| apart move g s / (|g s| +
    eps) by up to eps d / (s |g| (|g| - d)), so the parameters agree to
    1e-6 of max|p| + lr plus lr times that, entry by entry."""
    got, want, before, grad = (np.asarray(x, np.float64) for x in
                               (got, want, before, grad))
    diff = np.abs(got - want)
    slack = np.full(diff.shape, 1e-6 * (np.abs(before).max() + lr))
    decided = np.abs(grad) >= 1e-2 * np.abs(grad).max()
    d, g = grad_tol * np.abs(grad).max(), np.abs(grad[decided])
    slack[decided] += (lr * adamw.AdamWConfig().eps * d
                       / (scale * g * (g - d)))
    assert (diff[decided] <= slack[decided]).all(), (name, diff[decided].max())
    assert (diff <= 2 * lr + slack).all(), (name, diff.max())


# -- the launchers ----------------------------------------------------------

def _shape_of(out: str) -> list[str]:
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in out.splitlines()]


def test_train_main_mole_embedding_prints_the_reference_format(
        tmp_path, capsys):
    """``launch/train.py --arch llama32_vision_90b --smoke --mole embedding
    --kappa 4`` through the reference's ``main`` and the port's (``--device
    cpu``): the same header word for word, the same lines with the numbers
    taken out, finite losses."""
    argv = ["--arch", ARCH, "--smoke", "--mole", "embedding", "--kappa", "4",
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
    assert "mole=embedding" in head[0]
    losses = [float(h["loss"]) for h in hist if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("mole", ["token", "off"])
def test_serve_lm_matches_reference(mole, capsys):
    """``serve --mode lm --arch llama32_vision_90b --smoke``: the reference's
    ``run_lm`` (its own weights from the seed, zero gates, all-zero
    patches) against the port's on those weights carried over; with
    ``--mole token`` (2 tenants of 2 requests) one tenant at a time on
    fused params, unmorphed by the provider.  Held under ``_lm_parity``'s tie-margin rule against a
    teacher-forced reference forward on the same zero patches."""
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
