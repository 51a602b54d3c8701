"""The port's RWKV-6 scan and block on the CPU against the JAX reference:
the scan's plain versions (the CPU path of K6), the chunked time-mix scan,
and the time-mix and channel-mix blocks of the ``rwkv6_3b`` smoke config
(4 heads of 16, d 64, fp32).  The model, the decode lane and ``serve``
are held in ``test_torch_rwkv_lm.py``.

Inputs come from numpy with a seed (the scan's: the distribution of
``tests/test_kernels.py``'s wkv6 sweep, logw = -exp(N(0, 1)), s0 ~ 0.1 N);
the reference's parameters carry over with ``params_from_jax``.  Every
comparison is of numbers within a stated tolerance, each as a share of
the largest magnitude of the expected array:

  * ``SCAN_TOL`` 1e-4 for a chunked scan against another order of
    summation (the reference's own chunked form sits 7e-6 from its token
    recurrence at T = 300, D = 64);
  * ``SAME_TOL`` 1e-5 for the same algorithm in both packages (fp32);
  * the block outputs and caches: ``LOGIT_RTOL`` 1e-5 with an absolute
    floor of 1e-5 x max, as ``test_torch_models.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6 import wkv6_chunked as pallas_wkv6  # noqa: E402
from repro.models import blocks as jB, stack as jS  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref, wkv6_chunked  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Model, blocks as tB, params_from_jax, stack as tS,
)

ARCH = "rwkv6_3b"
SCAN_TOL = 1e-4
SAME_TOL = 1e-5
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


def _within(got, want, share):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    lim = share * float(np.abs(want).max())
    assert err <= lim, f"max|got - want| {err} > {lim}"


def _scan_inputs(rng, B, H, T, D):
    r, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, T, D)).astype(np.float32))
    u = rng.standard_normal((H, D)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _flat(a):
    return np.ascontiguousarray(a.reshape(-1, *a.shape[2:]))


# ---------------------------------------------------------------------------
# The scan: plain versions (K6's CPU path) and the time-mix's chunked form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,D,chunk,pad", [
    (64, 16, 16, 0), (128, 32, 32, 0), (96, 64, 32, 0), (40, 16, 16, 8),
])
def test_wkv6_plain_versions_match_reference(rng, T, D, chunk, pad):
    """``ref.wkv6_chunked_ref`` (through the K6 wrapper on CPU tensors, which
    launches nothing) against the Pallas kernel in interpret mode and the
    reference's token recurrence, over ``tests/test_kernels.py``'s sweep; a
    padded case (``pad`` zero steps at the end: k = v = r = 0, logw = 0)
    must leave the unpadded outputs and the state as they are.
    ``ref.wkv6_ref`` against the reference's ``wkv6_ref``."""
    B, H = 2, 2
    r, k, v, logw, u, s0 = _scan_inputs(rng, B, H, T, D)
    want_o, want_s = jref.wkv6_ref(*map(jnp.asarray, (r, k, v, logw, u, s0)))
    got_o, got_s = ref.wkv6_ref(*map(_t, (r, k, v, logw, u, s0)))
    _within(got_o, want_o, SAME_TOL)
    _within(got_s, want_s, SAME_TOL)

    zp = lambda a: np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0)))  # noqa: E731
    fr, fk, fv, flw = (_flat(zp(a)) for a in (r, k, v, logw))
    u_b = _flat(np.broadcast_to(u[None], (B, H, D)))
    pl_o, pl_s = pallas_wkv6(*map(jnp.asarray, (fr, fk, fv, flw, u_b,
                                                _flat(s0))), chunk=chunk)
    before = wkv6_chunked.launches
    co, cs = wkv6_chunked(*map(_t, (fr, fk, fv, flw, u_b, _flat(s0))),
                          chunk=chunk)
    assert wkv6_chunked.launches == before
    assert co.dtype == torch.float32 and cs.dtype == torch.float32
    _within(co, pl_o, SCAN_TOL)
    _within(cs, pl_s, SCAN_TOL)
    _within(co.reshape(B, H, T + pad, D)[:, :, :T], want_o, SCAN_TOL)
    _within(cs.reshape(B, H, D, D), want_s, SCAN_TOL)


@pytest.mark.parametrize("T,chunk,subchunk", [
    (128, 64, 16), (128, 64, 0), (100, 32, 0), (7, 16, 0),
])
def test_wkv_chunked_matches_reference(rng, T, chunk, subchunk):
    """The time-mix's scan (``blocks._wkv_chunked``: end padding, (B, H)
    flattening, ``u`` broadcast, K6 through its wrapper) against the
    reference's ``_wkv_chunked`` (its XLA forms, including the GEMM-form
    ``subchunk=16`` the port does not carry), with a nonzero s0."""
    B, H, D = 1, 2, 16
    r, k, v, logw, u, s0 = _scan_inputs(rng, B, H, T, D)
    jo, js = jB._wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u, s0)),
                             chunk=chunk, subchunk=subchunk)
    to, ts = tB._wkv_chunked(*map(_t, (r, k, v, logw, u, s0)), chunk)
    _within(to, jo, SCAN_TOL)
    _within(ts, js, SCAN_TOL)


def test_wkv6_wrapper_validates(rng):
    """The wrapper's contract on the CPU: shapes out, bf16 in -> bf16 out,
    and the refusals (a chunk that does not divide T, dtypes, shapes,
    layout, operands that require grad) raise before anything runs."""
    r, k, v, logw, u, s0 = (_t(_flat(a)) if a.ndim == 4 else _t(a)
                            for a in _scan_inputs(rng, 1, 2, 8, 16))
    u = u.reshape(2, 16)
    out, s = wkv6_chunked(r, k, v, logw, u, s0, chunk=4)
    assert out.shape == (2, 8, 16) and s.shape == (2, 16, 16)
    bf = wkv6_chunked(r.bfloat16(), k.bfloat16(), v.bfloat16(),
                      logw.bfloat16(), u, s0, chunk=4)[0]
    assert bf.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv6_chunked(r, k, v, logw, u, s0, chunk=3)
    with pytest.raises(TypeError):
        wkv6_chunked(r.double(), k, v, logw, u, s0, chunk=4)
    with pytest.raises(TypeError):
        wkv6_chunked(r, k, v, logw, u, s0.bfloat16(), chunk=4)
    with pytest.raises(ValueError, match="expected"):
        wkv6_chunked(r, k, v, logw, u[:1], s0, chunk=4)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_chunked(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                     logw, u, s0, chunk=4)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_chunked(r.requires_grad_(), k, v, logw, u, s0, chunk=4)


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """One rwkv block of the smoke config in both packages, every leaf
    perturbed (the zero-initialised token-shift mixes and norms too)."""
    rng = np.random.default_rng(11)
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    _, jp = _jparams(jcfg)
    jblock = jax.tree.map(
        lambda a: a[0] + 0.05 * rng.standard_normal(a.shape[1:]).astype(a.dtype),
        jp["blocks"]["b0"],
    )
    tblock = params_from_jax(
        {"embed": jp["embed"], "blocks": {"b0": jax.tree.map(
            lambda a: a[None], jblock)}},
        dataclasses.replace(cfg, n_groups=1), device="cpu",
    )["blocks"][0]
    return jcfg, cfg, jax.tree.map(jnp.asarray, jblock), tblock


@pytest.mark.parametrize("part", ["tm", "cm", "block"])
def test_rwkv_blocks_full_and_decode(rng, block, part):
    """Time-mix, channel-mix and the whole block: a prefill that writes the
    cache (T = 7 over chunk 4, so the scan pads), then two decode steps,
    against the reference, outputs and every cache leaf, rtol 1e-5."""
    jcfg, cfg, jblock, tblock = block
    B, S = 2, 7
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jc = jax.tree.map(lambda a: a[0], JModel(jcfg).init_cache(B, 16)["blocks"]["b0"])
    tc = Model(cfg, "cpu").init_cache(B, 16)["blocks"][0]

    def run(hx, jrs, trs):
        nonlocal jc
        if part == "tm":
            jo, jc = jB.apply_rwkv_tm(jblock["mix"], hx, jcfg, jrs, jc)
            to, _ = tB.apply_rwkv_tm(tblock["mix"], _t(hx), cfg, trs, tc)
        elif part == "cm":
            jo, jc = jB.apply_rwkv_cm(jblock["ffn"], hx, jcfg, jrs, jc)
            to, _ = tB.apply_rwkv_cm(tblock["ffn"], _t(hx), cfg, trs, tc)
        else:
            jo, jc = jS.apply_block(jblock, hx, jcfg, "rwkv", jrs, jc)
            to, _ = tS.apply_block(tblock, _t(hx), cfg, trs, tc, "rwkv")
        _close(to, jo)
        for name in ("s", "tm_x", "cm_x"):
            _close(tc[name], jc[name])

    run(jnp.asarray(h), jB.RunState(mode="full", write_cache=True),
        tB.RunState(mode="full", write_cache=True))
    for step in range(2):
        h1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        run(jnp.asarray(h1), jB.RunState(mode="decode", t=jnp.asarray(S + step)),
            tB.RunState(mode="decode", t=S + step))
