"""Shared set-up of the port's vision-language tests
(``test_torch_vlm.py``, ``test_torch_vlm_launch.py``): the smoke
``llama32_vision_90b`` in both packages on one set of weights with live
cross-layer gates, the float64 evaluation the tolerances are taken from,
and small conversions (see ``test_torch_vlm.py`` for the tolerances)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models.api import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import Model, params_from_jax
from repro_torch.optim import adamw

ARCH = "llama32_vision_90b"
CROSS = "b4"            # the cross layer's place in the block pattern
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TOL_CAP = 1e-2
B, S = 2, 12


def gated(jparams, seed: int):
    """The reference's tree with both gates of every cross layer and its
    ``ctx_norm`` drawn from ``seed`` (gates uniform in +-1)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jparams)
    mix = tree["blocks"][CROSS]["mix"]
    for name in ("gate_attn", "gate_ffn"):
        mix[name] = rng.uniform(-1, 1, mix[name].shape).astype(mix[name].dtype)
    mix["ctx_norm"] = (0.5 * rng.standard_normal(mix["ctx_norm"].shape)
                       ).astype(mix["ctx_norm"].dtype)
    return tree


def make_ref() -> dict:
    """The smoke model in both packages on the same gated weights, with
    random tokens, targets and patches."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    np_params = gated(JModel(jcfg).init(jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    fe = cfg.frontend
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "patches": rng.standard_normal((B, fe.n_tokens, fe.d_in)
                                       ).astype(np.float32),
    }
    c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    p64 = params_from_jax(jax.tree.map(lambda a: a.astype(np.float64),
                                       np_params), c64, "cpu")
    return {"jcfg": jcfg, "cfg": cfg, "np": np_params,
            "jparams": jax.tree.map(jnp.asarray, np_params),
            "params": params_from_jax(np_params, cfg, "cpu"), "batch": batch,
            "model64": Model(c64, "cpu"), "params64": p64}


def oracle_tol(pairs, floor: float) -> float:
    """Four times the reference's largest departure from the float64
    evaluation over ``pairs`` of (reference, float64) arrays, relative to
    max|float64|, or ``floor`` where that is larger; at most TOL_CAP."""
    dep = max(float(np.abs(np.asarray(w, np.float64)
                           - np.asarray(torch.as_tensor(e).double())).max())
              / (float(torch.as_tensor(e).abs().max()) or 1.0)
              for w, e in pairs)
    tol = max(floor, 4 * dep)
    assert tol <= TOL_CAP, tol
    return tol


def j_batch(batch):
    """A batch of numpy arrays as the reference's."""
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t_batch(batch):
    """A batch of numpy arrays as the port's (CPU tensors)."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def close_to(got, want, tol, what=""):
    """Within ``tol`` times max|want| everywhere."""
    got = np.asarray(torch.as_tensor(got).detach().double())
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def leaves(tree, cfg) -> dict:
    """A reference tree as the port's ``{dotted name: tensor}``."""
    np_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return dict(adamw.named_leaves(params_from_jax(np_tree, cfg, "cpu")))


def grads_of(model, params, batch, remat):
    """The port's loss and every leaf's gradient, by dotted name."""
    names, ts = zip(*adamw.named_leaves(params))
    with steps._grad_on(ts):
        loss = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, ts)
    return loss.detach(), dict(zip(names, grads))


def grad_tols(ref, want: dict, want_norm: float | None = None):
    """``oracle_tol`` of the reference's gradients ``want`` against the
    port's float64 evaluation's, over every leaf; and of the reference's
    global norm ``want_norm`` (over LOSS_RTOL), where given."""
    _, exact = grads_of(ref["model64"], ref["params64"],
                        t_batch(ref["batch"]), remat=False)
    norm_tol = None
    if want_norm is not None:
        norm = float(torch.sqrt(sum(torch.sum(g * g) for g in exact.values())))
        norm_tol = oracle_tol([(np.float64(want_norm), torch.tensor(norm))],
                              LOSS_RTOL)
    return (oracle_tol([(want[n].numpy(), exact[n]) for n in want], GRAD_TOL),
            norm_tol)


def hold_update(name, got, want, before, grad, lr, grad_tol, scale):
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
