"""Shared set-up of the port's audio encoder-decoder tests
(``test_torch_whisper.py``, ``test_torch_whisper_launch.py``): the smoke
``whisper_tiny`` in both packages on one set of weights (every norm scale
drawn from a seed: the init's zeros make a norm that ignores its weight
pass unseen), random tokens, targets and frames, and the float64
evaluation the tolerances are taken from (``_vlm_parity.oracle_tol``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as j_smoke
from repro.models.api import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model, params_from_jax

ARCH = "whisper_tiny"
B, S = 2, 12


def drawn_norms(jparams, seed: int):
    """The reference's tree (numpy leaves) with every norm scale (``norm1``,
    ``norm_cross``, ``norm2``, ``enc_norm``, ``final_norm``, ``ctx_norm``)
    drawn as 0.5 N(0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        if "norm" in jax.tree_util.keystr(path):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, jparams)


def frames_of(rng, cfg, rows: int) -> np.ndarray:
    fe = cfg.frontend
    return rng.standard_normal((rows, fe.n_tokens, fe.d_in)).astype(np.float32)


def make_ref() -> dict:
    """The smoke model in both packages on the same weights, with random
    tokens, targets and frames; the port's float64 evaluation beside."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    np_params = drawn_norms(JModel(jcfg).init(jax.random.key(0)), 1)
    rng = np.random.default_rng(2)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "frames": frames_of(rng, cfg, B),
    }
    c64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    p64 = params_from_jax(jax.tree.map(lambda a: a.astype(np.float64),
                                       np_params), c64, "cpu")
    return {"jcfg": jcfg, "cfg": cfg, "np": np_params,
            "jparams": jax.tree.map(jnp.asarray, np_params),
            "params": params_from_jax(np_params, cfg, "cpu"), "batch": batch,
            "model64": Model(c64, "cpu"), "params64": p64}
