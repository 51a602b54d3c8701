"""K6: the RWKV-6 linear-attention scan, on Hopper.

Replaces the Pallas kernel ``wkv6_chunked`` (``repro/kernels/wkv6.py:71``),
the RWKV-6 recurrence ``out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``,
``S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T`` for each of ``BH`` (batch x
head) sequences.  :func:`wkv6_chunked` launches the hand-written kernel in
``csrc/wkv6.cu`` (bound in :mod:`.gemm`), which runs that recurrence column
by column of the ``(D, D)`` state, each column's rows split over a few
threads that keep them in registers, in the form :func:`.gemm.scan_form`
picks for the shape (the source says why and what bounds each):

  * the columns form: blocks of :func:`.gemm.scan_width` columns, each
    walking the whole sequence; one device launch a call (the prefill's
    shapes);
  * the time-chunked form: a block per sequence and chunk of L tokens runs
    the recurrence from a zero state, the chunks' start states are chained
    in order, and each token's read-out is corrected by its chunk's start
    state; two device launches a call, the zeroed sync words and the kernel
    (``rwkv_train``'s (80, 4096)).

``chunk`` is validated as the Pallas kernel asserts it, but the kernel's
result does not depend on it, nor on the form, beyond rounding; the CPU path
computes the chunked form at ``chunk``.

The kernel computes in fp32.  bf16 operands are converted to fp32 before
the launch and ``out`` is rounded back to ``r.dtype`` (what the Pallas
kernel, which casts every block to fp32, returns); ``s_final`` is fp32.
Any other dtype raises.  Head sizes 16 and 64 and chunks of at most 128
tokens have a kernel; others raise on the card.

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs :func:`.ref.wkv6_chunked_ref`.
Calls are counted in ``wkv6_chunked.launches``, one a call whatever the
form's device launches.  :func:`wkv6_chunked`
takes no operand that requires grad (it raises, as the Pallas kernel has no
backward); gradients go through :func:`wkv6_scan`, the autograd Function
:class:`WKV6Scan`.

The gradient.  Write the recurrence as ``o_t = r_t^T S_{t-1} + c_t v_t``
with ``c_t = sum_d r_td u_d k_td`` and ``S_t = diag(w_t) S_{t-1} + k_t
v_t^T``.  Given ``dO`` and ``dS_T``, the state's gradient ``G_t =
dL/dS_t`` runs backwards: ``G_{t-1} = diag(w_t) G_t + r_t dO_t^T`` from
``G_{T-1} = dS_T``.  Then

  * dv and ds0 are K6 itself over the flipped sequence, with r' = k,
    k' = r, v' = dO, the same logw and u, from ``dS_T``: its out is
    ``G_t^T k_t + c_t dO_t`` (c is symmetric in r and k), its final
    state ``G_{-1}``;
  * ``dr = S_{t-1} dO_t + u k_t (v_t . dO_t)`` and ``dk = G_t v_t + u r_t
    (v_t . dO_t)``: the state parts come from the key-row scan
    :func:`wkv6_rows` (``csrc/wkv6_rows.cu``), forward on (k, v, dO) from
    s0 and over the flipped sequence on (r, dO, v) from ``dS_T``;
  * ``du = sum_t r_t k_t (v_t . dO_t)``;
  * ``dlogw_m = rowsum(S_T * dS_T) + sum_{t>m} r_t (S_{t-1} dO_t) -
    sum_{s>=m} k_s (G_s v_s)``, from the final state alone (no state is
    stored or recomputed).  The two sums grow with T while their
    difference does not, so they are taken in float64.
"""
from __future__ import annotations

import torch

from . import gemm, ref

__all__ = ["WKV6Scan", "wkv6_chunked", "wkv6_rows", "wkv6_scan"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_CHUNK = 128
_HEAD_SIZES = (16, 64)        # rwkv6_3b's smoke and full head sizes


def _check_operands(name: str, ops) -> None:
    """Plain tensors on one device, contiguous, non-empty, no operand that
    requires grad."""
    gemm.refuse_dtensor(name, *ops)
    if any(a.device != ops[0].device for a in ops):
        raise ValueError(f"{name}: operands on different devices "
                         f"{[str(a.device) for a in ops]}")
    if any(a.requires_grad for a in ops):
        raise RuntimeError(
            f"{name}: has no backward; pass operands that do not require grad"
            f" (wkv6_scan differentiates the scan)"
        )
    if not all(a.is_contiguous() for a in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if ops[0].numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(ops[0].shape)}")


def _check_card(name: str, BH: int, D: int, ops) -> None:
    """What a launch on the card takes beyond the shapes: a CUDA device, a
    head size with a kernel, the grid limit, 16-byte aligned operands."""
    if ops[0].device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {ops[0].device}")
    if D not in _HEAD_SIZES:
        raise ValueError(f"{name}: no kernel for head size {D} (head sizes "
                         f"{_HEAD_SIZES})")
    if BH > gemm.MAX_GRID_YZ:
        raise ValueError(f"{name}: {BH} sequences exceed the grid limit")
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def wkv6_chunked(
    r: torch.Tensor,        # (BH, T, D)
    k: torch.Tensor,        # (BH, T, D)
    v: torch.Tensor,        # (BH, T, D)
    logw: torch.Tensor,     # (BH, T, D), <= 0
    u: torch.Tensor,        # (BH, D)
    s0: torch.Tensor,       # (BH, D, D) fp32, key x value
    *,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (BH, T, D) in ``r.dtype``, s_final (BH, D, D) fp32).
    ``T`` must divide by ``min(chunk, T)`` (the Pallas kernel asserts it;
    here it raises ``ValueError``): callers pad the end.  On the card the
    result is the token recurrence's, whatever the chunk."""
    name = "wkv6_chunked"
    seq = (r, k, v, logw)
    ops = (*seq, u, s0)
    BH, T, D = r.shape if r.dim() == 3 else (0, 0, 0)
    if (r.dim() != 3 or any(a.shape != r.shape for a in seq)
            or u.shape != (BH, D) or s0.shape != (BH, D, D)):
        raise ValueError(
            f"{name}: expected r/k/v/logw (BH, T, D), u (BH, D), s0 (BH, D, D); "
            f"got {[tuple(a.shape) for a in ops]}"
        )
    if any(a.dtype not in _DTYPES for a in (*seq, u)) or s0.dtype != torch.float32:
        raise TypeError(
            f"{name}: expected float32 or bfloat16 r/k/v/logw/u and a float32 "
            f"s0, got {[str(a.dtype) for a in ops]}"
        )
    _check_operands(name, ops)
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"{name}: T = {T} is not a multiple of the chunk {L}")
    if r.device.type == "cpu":
        return ref.wkv6_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    if L > _MAX_CHUNK:
        raise ValueError(f"{name}: no kernel for chunk {L} (chunks up to "
                         f"{_MAX_CHUNK})")
    r32, k32, v32, lw32, u32 = (a.float() for a in (*seq, u))
    _check_card(name, BH, D, (r32, k32, v32, lw32, u32, s0))
    out, s_fin = gemm.scan(name, r32, k32, v32, lw32, u32, s0)
    wkv6_chunked.launches += 1
    return out.to(r.dtype), s_fin


wkv6_chunked.launches = 0


def wkv6_rows(
    x: torch.Tensor,        # (BH, T, D)
    y: torch.Tensor,        # (BH, T, D)
    z: torch.Tensor,        # (BH, T, D)
    logw: torch.Tensor,     # (BH, T, D), <= 0
    s0: torch.Tensor,       # (BH, D, D)
) -> torch.Tensor:
    """The key-row scan of K6's gradient: from ``M = s0``, at each token
    ``out_t[i] = M[i, :] . z_t``, then ``M[i, :] = e^{logw_t[i]} M[i, :] +
    x_t[i] y_t``.  Returns out (BH, T, D).  Every operand fp32.  A CUDA
    tensor launches ``csrc/wkv6_rows.cu`` (head sizes 16 and 64; counted in
    ``wkv6_rows.launches``) or raises; a CPU tensor runs
    :func:`.ref.wkv6_rows_ref`."""
    name = "wkv6_rows"
    seq = (x, y, z, logw)
    ops = (*seq, s0)
    BH, T, D = x.shape if x.dim() == 3 else (0, 0, 0)
    if (x.dim() != 3 or any(a.shape != x.shape for a in seq)
            or s0.shape != (BH, D, D)):
        raise ValueError(
            f"{name}: expected x/y/z/logw (BH, T, D) and s0 (BH, D, D); got "
            f"{[tuple(a.shape) for a in ops]}"
        )
    if any(a.dtype != torch.float32 for a in ops):
        raise TypeError(f"{name}: expected float32 operands, got "
                        f"{[str(a.dtype) for a in ops]}")
    _check_operands(name, ops)
    if x.device.type == "cpu":
        return ref.wkv6_rows_ref(x, y, z, logw, s0)
    _check_card(name, BH, D, ops)
    out = gemm.key_rows(name, x, y, z, logw, s0)
    wkv6_rows.launches += 1
    return out


wkv6_rows.launches = 0


class WKV6Scan(torch.autograd.Function):
    """:func:`wkv6_chunked` with its gradient (the module docstring derives
    it): the forward is K6 on the detached operands; the backward is one
    K6 launch on flipped operands (dv, ds0), two :func:`wkv6_rows`
    launches (the state parts of dr and dk) and elementwise terms and
    reverse sums in torch ops.  Only the operands and the final state are
    kept.  fp32 operands; a gradient of ``s_final`` that is None counts as
    zero; an operand that needs no gradient gets None.  On the CPU the same
    decomposition runs with the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, chunk):
        ops = tuple(a.detach() for a in (r, k, v, logw, u, s0))
        out, s_fin = wkv6_chunked(*ops, chunk=chunk)
        ctx.save_for_backward(*ops, s_fin)
        ctx.chunk = chunk
        return out, s_fin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out, d_s):
        r, k, v, logw, u, s0, s_fin = ctx.saved_tensors
        d_out = (torch.zeros_like(r) if d_out is None
                 else d_out.float().contiguous())
        d_s = torch.zeros_like(s0) if d_s is None else d_s.float().contiguous()
        dv, ds0 = wkv6_chunked(k.flip(1), r.flip(1), d_out.flip(1),
                               logw.flip(1), u, d_s, chunk=ctx.chunk)
        dr_s = wkv6_rows(k, v, d_out, logw, s0)            # S_{t-1} dO_t
        dk_g = wkv6_rows(r.flip(1), d_out.flip(1), v.flip(1), logw.flip(1),
                         d_s).flip(1)                       # G_t v_t
        vdo = (v * d_out).sum(-1, keepdim=True)             # v_t . dO_t
        a = r.double().mul_(dr_s)
        c = k.double().mul_(dk_g).neg_().add_(a).flip(1).cumsum_(1).flip(1)
        phi = (s_fin.double() * d_s).sum(-1)
        grads = (dr_s + u[:, None] * k * vdo, dk_g + u[:, None] * r * vdo,
                 dv.flip(1), c.sub_(a).add_(phi[:, None]).float(),
                 (r * k * vdo).sum(1), ds0)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
              chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv6_chunked` on fp32 operands that may require grad
    (:class:`WKV6Scan`).  Returns (out (BH, T, D), s_final (BH, D, D))."""
    ops = (r, k, v, logw, u, s0)
    if any(a.dtype != torch.float32 for a in ops):
        raise TypeError(f"wkv6_scan: expected float32 operands, got "
                        f"{[str(a.dtype) for a in ops]}")
    return WKV6Scan.apply(r, k, v, logw, u, s0, chunk)
