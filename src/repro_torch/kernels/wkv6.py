"""K6: the RWKV-6 linear-attention scan, on Hopper.

Replaces the Pallas kernel ``wkv6_chunked`` (``repro/kernels/wkv6.py:71``),
the RWKV-6 recurrence ``out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)``,
``S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T`` for each of ``BH`` (batch x
head) sequences.  :func:`wkv6_chunked` launches the hand-written kernel in
``csrc/wkv6.cu`` (bound in :mod:`.gemm`), which runs that recurrence column
by column of the ``(D, D)`` state: the columns are independent, each one's
rows are split over a few threads that keep them in registers, and the
blocks of one sequence share nothing (the source says why and what bounds
it; :func:`.gemm.scan_width` picks the blocks' width).  ``chunk`` is
validated as the Pallas kernel asserts it, but the kernel's result does not
depend on it beyond rounding; the CPU path computes the chunked form at
``chunk``.

The kernel computes in fp32.  bf16 operands are converted to fp32 before
the launch and ``out`` is rounded back to ``r.dtype`` (what the Pallas
kernel, which casts every block to fp32, returns); ``s_final`` is fp32.
Any other dtype raises.  Head sizes 16 and 64 and chunks of at most 128
tokens have a kernel; others raise on the card.

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs :func:`.ref.wkv6_chunked_ref`.
Launches are counted in ``wkv6_chunked.launches``.  The kernel has no
backward, like the Pallas kernel: an operand that requires grad raises.
"""
from __future__ import annotations

import torch

from . import gemm, ref

__all__ = ["wkv6_chunked"]

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_CHUNK = 128
_HEAD_SIZES = (16, 64)        # rwkv6_3b's smoke and full head sizes


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
    if any(a.device != r.device for a in ops):
        raise ValueError(f"{name}: operands on different devices "
                         f"{[str(a.device) for a in ops]}")
    if any(a.dtype not in _DTYPES for a in (*seq, u)) or s0.dtype != torch.float32:
        raise TypeError(
            f"{name}: expected float32 or bfloat16 r/k/v/logw/u and a float32 "
            f"s0, got {[str(a.dtype) for a in ops]}"
        )
    if any(a.requires_grad for a in ops):
        raise RuntimeError(
            f"{name}: has no backward; pass operands that do not require grad"
        )
    if not all(a.is_contiguous() for a in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if r.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(r.shape)}")
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"{name}: T = {T} is not a multiple of the chunk {L}")
    if r.device.type == "cpu":
        return ref.wkv6_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {r.device}")
    if D not in _HEAD_SIZES or L > _MAX_CHUNK:
        raise ValueError(
            f"{name}: no kernel for head size {D} and chunk {L} (head sizes "
            f"{_HEAD_SIZES}, chunks up to {_MAX_CHUNK})"
        )
    if BH > gemm.MAX_GRID_YZ:
        raise ValueError(f"{name}: {BH} sequences exceed the grid limit")
    r32, k32, v32, lw32, u32 = (a.float() for a in (*seq, u))
    if any(a.data_ptr() % 16 for a in (r32, k32, v32, lw32, u32, s0)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    out, s_fin = gemm.scan(name, r32, k32, v32, lw32, u32, s0)
    wkv6_chunked.launches += 1
    return out.to(r.dtype), s_fin


wkv6_chunked.launches = 0
