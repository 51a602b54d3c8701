"""Slot-indexed grouped GEMMs for the delivery engine, on Hopper.

The engine's microbatch carries a ``(G,)`` vector of *slot indices* into the
stacked per-tenant secrets (``cores (S, q, q)``, ``c_acs (S, K, N)``).  Both
wrappers launch the hand-written CUDA kernel in ``csrc/grouped_gemm.cu``,
which reads each group's slot straight out of the stack (no ``(G, ...)``
gather copy), for any index vector and any shape:

  * :func:`grouped_block_diag_matmul` replaces the Pallas kernel of the same
    name (``repro/kernels/grouped.py``): ``x`` viewed as ``(G, B*kappa, q)``
    times the slot's core;
  * :func:`grouped_aug_gemm` replaces ``grouped_aug_gemm``: ``t[g]`` times
    the slot's Aug-Conv matrix.

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref.py``.
There is no other switch.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

__all__ = ["grouped_block_diag_matmul", "grouped_aug_gemm"]

_MAX_GRID_YZ = 65535
_BM = 64            # rows per block in grouped_gemm.cu


@functools.cache
def _kernel():
    lib = build.load("grouped_gemm")
    fn = lib.grouped_sgemm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.grouped_sgemm_error_string.argtypes = [ctypes.c_int]
    lib.grouped_sgemm_error_string.restype = ctypes.c_char_p
    return fn, lib.grouped_sgemm_error_string


def _check(name: str, a: torch.Tensor, gidx: torch.Tensor,
           b: torch.Tensor) -> None:
    """What the kernel takes: one device, fp32 operands, int32 gidx (G,),
    contiguous, non-empty, within the grid limits."""
    if not (a.device == gidx.device == b.device):
        raise ValueError(
            f"{name}: operands on different devices "
            f"({a.device}, {gidx.device}, {b.device})"
        )
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 operands, got {a.dtype}, {b.dtype}")
    if gidx.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 gidx, got {gidx.dtype}")
    if a.dim() != 3 or b.dim() != 3 or gidx.shape != (a.shape[0],):
        raise ValueError(
            f"{name}: expected (G, B, F), (G,), (S, ., .); got "
            f"{tuple(a.shape)}, {tuple(gidx.shape)}, {tuple(b.shape)}"
        )
    if not (a.is_contiguous() and gidx.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if min(a.shape) == 0 or min(b.shape) == 0:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: {a.shape[0]} groups exceed the grid limit")


def _launch(a, gidx, b, out, M: int, N: int, K: int) -> None:
    """out[g] = a[g] (M, K) @ b[gidx[g]] (K, N) on the current stream."""
    if -(-M // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{M} rows per group exceed the grid limit")
    fn, err_str = _kernel()
    err = fn(
        a.data_ptr(), gidx.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.shape[0], M, N, K, b.shape[0], a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"grouped_sgemm launch failed: {err_str(err).decode()} ({err})"
        )


def grouped_block_diag_matmul(
    x: torch.Tensor,        # (G, B, F) with F = kappa * q
    gidx: torch.Tensor,     # (G,) int32 slot index per group
    cores: torch.Tensor,    # (S, q, q) stacked per-slot morph cores
    kappa: int,
) -> torch.Tensor:
    """Per-group repeated-block-diagonal morph, secrets read in place.

    ``y[g] = reshape(x[g], (B, kappa, q)) @ cores[gidx[g]]``.
    """
    _check("grouped_block_diag_matmul", x, gidx, cores)
    G, B, F = x.shape
    q = cores.shape[-1]
    if cores.shape[1] != q or F != kappa * q:
        raise ValueError(
            f"grouped_block_diag_matmul: x {tuple(x.shape)} is not kappa={kappa} "
            f"blocks of the cores {tuple(cores.shape)}"
        )
    if x.device.type == "cpu":
        return ref.block_diag_matmul_grouped_ref(x, gidx, cores, kappa)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_block_diag_matmul: no kernel for {x.device}")
    out = torch.empty_like(x)
    _launch(x, gidx, cores, out, M=B * kappa, N=q, K=q)
    grouped_block_diag_matmul.launches += 1
    return out


def grouped_aug_gemm(
    t: torch.Tensor,        # (G, B, K) morphed rows
    gidx: torch.Tensor,     # (G,) int32 slot index per group
    c_acs: torch.Tensor,    # (S, K, N) stacked per-slot Aug-Conv matrices
) -> torch.Tensor:
    """Per-group Aug-Conv forward ``t[g] @ c_acs[gidx[g]]``, secrets in place."""
    _check("grouped_aug_gemm", t, gidx, c_acs)
    G, B, K = t.shape
    N = c_acs.shape[-1]
    if c_acs.shape[1] != K:
        raise ValueError(
            f"grouped_aug_gemm: t {tuple(t.shape)} does not match c_acs "
            f"{tuple(c_acs.shape)}"
        )
    if t.device.type == "cpu":
        return ref.aug_gemm_grouped_ref(t, gidx, c_acs)
    if t.device.type != "cuda":
        raise ValueError(f"grouped_aug_gemm: no kernel for {t.device}")
    out = torch.empty((G, B, N), dtype=t.dtype, device=t.device)
    _launch(t, gidx, c_acs, out, M=B, N=N, K=K)
    grouped_aug_gemm.launches += 1
    return out


grouped_block_diag_matmul.launches = 0
grouped_aug_gemm.launches = 0
