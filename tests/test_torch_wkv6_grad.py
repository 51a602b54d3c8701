"""The gradient of the RWKV-6 scan on the CPU: ``kernels/wkv6.py``
``WKV6Scan`` (through ``models/blocks.py`` ``_wkv_chunked``, which pads,
flattens and broadcasts ``u``) and the plain key-row scan
``ref.wkv6_rows_ref``.  On the CPU the Function runs its decomposition with
the plain versions (K6's chunked form, the key-row token loop), so these
tests hold the decomposition itself; the card runs the same Function with
the kernels (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs come from numpy with a seed: r, k, v, dO ~ N(0, 1); logw = -exp(z)
(ordinary), -exp(2 z) (strong: most decays underflow) or -exp(z - 3)
(weak: w in about (0.9, 1)) for z ~ N(0, 1); u ~ N(0, 1); s0 and dS_T ~
0.1 N(0, 1).  The six gradients (r, k, v, logw, u, s0) of
``sum(out * dO) + sum(s_final * dS_T)`` are held, each as a share of the
largest magnitude of its float64 value, against:

  * float64 autograd of the token recurrence, written here
    (:func:`_recurrence`): within ``F64_TOL`` 1e-4, the plain chunked
    form's bound against the recurrence (``tests/test_torch_rwkv.py``'s
    ``SCAN_TOL``).  The backward's K6 launch is that chunked form on the
    CPU; under strong decay at chunk 128 its dv and ds0 depart by up to
    6.4e-5 (its cumulative log-decays reach hundreds), every other
    gradient by at most 1.4e-6.  dlogw, whose reverse sums grow with T
    while their difference does not, is held on its own at ``DLOGW_TOL``
    1e-5 (measured at most 1.4e-6);
  * ``jax.vjp`` of the reference's ``repro.models.blocks._wkv_chunked`` in
    fp32: within ``F64_TOL`` (``DLOGW_TOL`` for dlogw) plus the
    reference's own departure from float64, which is printed (up to
    9.7e-5, dr under strong decay at chunk 128).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.blocks import _wkv_chunked as j_wkv_chunked  # noqa: E402
from repro_torch.kernels import ref, wkv6_chunked, wkv6_rows, wkv6_scan  # noqa: E402
from repro_torch.kernels.wkv6 import WKV6Scan  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

F64_TOL = 1e-4
DLOGW_TOL = 1e-5
ROWS_TOL = 1e-6        # the key-row token loop in fp32 against float64
NAMES = ("r", "k", "v", "logw", "u", "s0")
DECAYS = {"ordinary": lambda z: -np.exp(z), "strong": lambda z: -np.exp(2 * z),
          "weak": lambda z: -np.exp(z - 3)}


def _inputs(seed, B, H, T, D, decay):
    """(r, k, v, logw, u, s0) as (B, H, T, D), u (H, D), s0 (B, H, D, D),
    and the cotangents dO (B, H, T, D), dS (B, H, D, D); numpy fp32."""
    g = np.random.default_rng(seed)
    r, k, v, z, dO = (g.standard_normal((B, H, T, D)).astype(np.float32)
                      for _ in range(5))
    logw = DECAYS[decay](z).astype(np.float32)
    u = g.standard_normal((H, D)).astype(np.float32)
    s0, dS = ((g.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
              for _ in range(2))
    return (r, k, v, logw, u, s0), dO, dS


def _recurrence(r, k, v, logw, u, s0):
    """The token recurrence on (B, H, T, D) operands, u (H, D), in their
    own dtype: out_t = r_t (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t)
    S_{t-1} + k_t v_t^T."""
    s, outs = s0, []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhd,bhdv->bhv", r[:, :, t],
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, :, t])[..., None] * s + kv
    return torch.stack(outs, 2), s


def _grads(fn, ops, dO, dS, dtype):
    """The six gradients of sum(out dO) + sum(s_final dS) through ``fn``,
    as float64 numpy arrays."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in ops]
    out, s_fin = fn(*ts)
    loss = ((out * torch.from_numpy(dO).to(dtype)).sum()
            + (s_fin * torch.from_numpy(dS).to(dtype)).sum())
    return [g.double().numpy() for g in torch.autograd.grad(loss, ts)]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("D,chunk,T,decay", [
    (16, 4, 37, "ordinary"), (16, 4, 37, "strong"), (16, 4, 37, "weak"),
    (64, 128, 150, "ordinary"), (64, 128, 150, "weak"),
    (64, 128, 300, "strong"), (64, 4, 23, "strong"), (16, 128, 1, "ordinary"),
])
def test_scan_gradients_match_float64_and_reference(D, chunk, T, decay):
    """The Function's six gradients through ``_wkv_chunked`` (T = 37 and 23
    pad to the chunk of 4, T = 150 and 300 to 256 and 384; T = 1 is one
    token) against float64 autograd of the token recurrence and against
    ``jax.vjp`` of the reference's chunked scan."""
    ops, dO, dS = _inputs(D + T, 2, 2, T, D, decay)
    want = _grads(_recurrence, ops, dO, dS, torch.float64)
    got = _grads(lambda *a: blocks._wkv_chunked(*a, chunk), ops, dO, dS,
                 torch.float32)
    _, vjp = jax.vjp(lambda *a: j_wkv_chunked(*a, chunk), *map(jnp.asarray, ops))
    ref_g = [np.asarray(g, np.float64)
             for g in vjp((jnp.asarray(dO), jnp.asarray(dS)))]
    for name, g, w, j in zip(NAMES, got, want, ref_g):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        tol = DLOGW_TOL if name == "logw" else F64_TOL
        ref_dep = _rel(j, w)
        print(f"d{name}: port {_rel(g, w):.2e}, reference {ref_dep:.2e} "
              f"of max|float64| {np.abs(w).max():.3g}")
        assert _rel(g, w) <= tol, (name, _rel(g, w))
        assert float(np.abs(g - j).max()) <= (tol + ref_dep) * np.abs(w).max(), name


def test_gradient_of_s_final_none_is_zero_and_unneeded_grads_are_none():
    """Without a use of s_final its gradient is None and counts as zero (the
    same gradients as an explicit zero dS); an operand that does not
    require grad gets none, and the others keep their values."""
    ops, dO, _ = _inputs(3, 1, 2, 12, 16, "ordinary")
    flat = [torch.from_numpy(a.reshape(2, *a.shape[2:])) for a in ops[:4]]
    u, s0 = torch.from_numpy(ops[4]), torch.from_numpy(ops[5][0])
    d_out = torch.from_numpy(dO.reshape(2, 12, 16))

    def grads(need, with_zero_ds):
        ts = [a.clone().requires_grad_(n) for a, n in zip((*flat, u, s0), need)]
        out, s_fin = wkv6_scan(*ts, chunk=4)
        loss = (out * d_out).sum()
        if with_zero_ds:
            loss = loss + (s_fin * torch.zeros_like(s_fin)).sum()
        wanted = [t for t in ts if t.requires_grad]
        return dict(zip([i for i, n in enumerate(need) if n],
                        torch.autograd.grad(loss, wanted)))

    every = grads([True] * 6, False)
    assert all(torch.equal(every[i], g) for i, g in grads([True] * 6, True).items())
    some = grads([False, True, False, True, False, False], False)
    assert sorted(some) == [1, 3]
    assert all(torch.equal(every[i], g) for i, g in some.items())
    # The Function itself returns None where no gradient is asked for.
    ctx_needs = []

    class Probe(WKV6Scan):
        @staticmethod
        def backward(ctx, d_out, d_s):
            out = WKV6Scan.backward(ctx, d_out, d_s)
            ctx_needs.append([g is not None for g in out])
            return out

    ts = [a.clone().requires_grad_(n) for a, n in
          zip((*flat, u, s0), [False, False, True, False, True, False])]
    out, _ = Probe.apply(*ts, 4)
    (out * d_out).sum().backward()
    assert ctx_needs == [[False, False, True, False, True, False, False]]


def test_scan_refuses_what_it_does_not_differentiate():
    """fp32 operands only (the backward computes in fp32); K6's own wrapper
    still refuses operands that require grad."""
    ops, _, _ = _inputs(4, 1, 1, 8, 16, "ordinary")
    flat = [torch.from_numpy(a.reshape(1, *a.shape[2:])) for a in ops[:4]]
    u, s0 = torch.from_numpy(ops[4]), torch.from_numpy(ops[5][0])
    with pytest.raises(TypeError, match="float32"):
        wkv6_scan(*(a.bfloat16() for a in flat), u, s0, chunk=4)
    with pytest.raises(RuntimeError, match="wkv6_scan"):
        wkv6_chunked(flat[0].requires_grad_(), *flat[1:], u, s0, chunk=4)


def test_no_grad_scan_gives_the_bits_of_the_kernel_call():
    """Without grad ``_wkv_chunked`` is the K6 wrapper on the padded, flattened
    operands, bit for bit (serving's path); with grad the Function's forward
    gives the same bits."""
    ops, _, _ = _inputs(5, 2, 3, 37, 16, "ordinary")
    r, k, v, logw, u, s0 = map(torch.from_numpy, ops)
    pad = (0, 0, 0, 3)
    flat = [torch.nn.functional.pad(a, pad).reshape(6, 40, 16)
            for a in (r, k, v, logw)]
    want_o, want_s = wkv6_chunked(*flat, u[None].expand(2, 3, 16).reshape(6, 16)
                                  .contiguous(), s0.reshape(6, 16, 16), chunk=4)
    with torch.no_grad():
        got_o, got_s = blocks._wkv_chunked(r, k, v, logw, u, s0, 4)
    assert torch.equal(got_o, want_o.reshape(2, 3, 40, 16)[:, :, :37])
    assert torch.equal(got_s, want_s.reshape(2, 3, 16, 16))
    grad_o, grad_s = blocks._wkv_chunked(r.requires_grad_(), k, v, logw, u, s0, 4)
    assert grad_o.grad_fn is not None
    assert torch.equal(grad_o.detach(), got_o) and torch.equal(grad_s.detach(), got_s)


def _rows_loop(x, y, z, logw, s0):
    """The key-row scan token by token in float64 numpy."""
    x, y, z, logw, m = (a.astype(np.float64) for a in (x, y, z, logw, s0))
    out = np.empty_like(x)
    for t in range(x.shape[1]):
        out[:, t] = np.einsum("bij,bj->bi", m, z[:, t])
        m = np.exp(logw[:, t])[:, :, None] * m + x[:, t, :, None] * y[:, t, None, :]
    return out


@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("BH,T,D", [(3, 45, 16), (2, 33, 64), (4, 1, 64)])
def test_rows_plain_version_matches_a_token_loop(BH, T, D, decay):
    """``ref.wkv6_rows_ref`` (through the wrapper on CPU tensors) against
    the scan in float64, within ``ROWS_TOL`` of max|float64|."""
    (r, k, v, logw, _, _), dO, dS = _inputs(T, 1, BH, T, D, decay)
    x, y, z, lw = (a[0] for a in (k, v, dO, logw))
    s0 = dS[0]
    before = wkv6_rows.launches
    got = wkv6_rows(*map(torch.from_numpy, (x, y, z, lw, s0)))
    assert wkv6_rows.launches == before       # the CPU launches no kernel
    want = _rows_loop(x, y, z, lw, s0)
    assert got.dtype == torch.float32 and got.shape == (BH, T, D)
    assert _rel(got.double().numpy(), want) <= ROWS_TOL
    np.testing.assert_array_equal(got.numpy(),
                                  ref.wkv6_rows_ref(*map(torch.from_numpy,
                                                         (x, y, z, lw, s0))))


def test_rows_wrapper_validates():
    """Shapes, dtypes, layout and grad are refused before anything runs."""
    x = torch.zeros(2, 8, 16)
    s0 = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="expected"):
        wkv6_rows(x, x, x, x, s0[:1])
    with pytest.raises(TypeError, match="float32"):
        wkv6_rows(x.double(), x, x, x, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_rows(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, x, s0)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_rows(x.clone().requires_grad_(), x, x, x, s0)
