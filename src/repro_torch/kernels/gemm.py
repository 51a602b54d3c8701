"""The ctypes binding of the port's CUDA sources and the checks their
wrappers share.

``csrc/grouped_gemm.cu`` has two entry points: ``grouped_sgemm`` (K1/K2,
slot-indexed, fp32; :mod:`.grouped`) and ``gemm_typed`` (K4 in
:mod:`.block_diag`, K5 in :mod:`.aug_gemm`: one matrix per group, fp32 or
bf16 operands).  ``csrc/row_gemm.cu`` has ``row_gemm`` (K3; :mod:`.grouped`).
``csrc/wkv6.cu`` has ``wkv6_chunked`` (K6, the RWKV-6 scan; :mod:`.wkv6`).
Each wrapper counts its own launches; this module counts none.  The
libraries are built at first use (:mod:`.build`); nothing here runs at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["MAX_GRID_YZ", "check_operands", "grouped", "typed", "rows", "scan"]

MAX_GRID_YZ = 65535
_BM = 64            # rows per block in grouped_gemm.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {   # symbol -> (library, argtypes)
    # a, gidx, b, out, G, M, N, K, S, device, stream
    "grouped_sgemm": ("grouped_gemm", [_P] * 4 + [_I] * 6 + [_P]),
    # a, b, out, G, M, N, K, bf16, device, stream
    "gemm_typed": ("grouped_gemm", [_P] * 3 + [_I] * 6 + [_P]),
    # h, gidx, tables, out, R, N, K, S, bf16, device, stream
    "row_gemm": ("row_gemm", [_P] * 4 + [_I] * 6 + [_P]),
    # r, k, v, logw, u, s0, out, s_out, BH, T, D, L, P, device, stream
    "wkv6_chunked": ("wkv6", [_P] * 8 + [_I] * 6 + [_P]),
}


@functools.cache
def _entry(symbol: str):
    lib_name, argtypes = _ENTRIES[symbol]
    lib = build.load(lib_name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{lib_name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def _call(name: str, symbol: str, a: torch.Tensor, *args) -> None:
    """Launch ``symbol`` on ``a``'s device and current stream; raise with
    the CUDA error string if the launch was refused."""
    fn, err_str = _entry(symbol)
    err = fn(*args, a.device.index, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} ({err})")


def check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                   dtypes: tuple[torch.dtype, ...]) -> None:
    """What every entry point takes: one device, one dtype out of
    ``dtypes``, contiguous, non-empty, no operand that requires grad (the
    kernels have no backward), at most ``MAX_GRID_YZ`` groups when 3-D."""
    if a.device != b.device:
        raise ValueError(f"{name}: operands on different devices "
                         f"({a.device}, {b.device})")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(
            f"{name}: expected two operands of one dtype out of "
            f"{[str(d) for d in dtypes]}, got {a.dtype}, {b.dtype}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if a.numel() == 0 or b.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(a.shape)}, {tuple(b.shape)}")
    if a.requires_grad or b.requires_grad:
        raise RuntimeError(
            f"{name}: has no backward; pass operands that do not require grad"
        )
    if a.dim() == 3 and a.shape[0] > MAX_GRID_YZ:
        raise ValueError(f"{name}: {a.shape[0]} groups exceed the grid limit")


def _check_rows(name: str, M: int) -> None:
    if -(-M // _BM) > MAX_GRID_YZ:
        raise ValueError(f"{name}: {M} rows per group exceed the grid limit")


def grouped(name: str, a: torch.Tensor, gidx: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """``out[g] = a[g] (M, K) @ b[clamp(gidx[g])] (K, N)``, fp32 (K1/K2)."""
    G, M, K = a.shape
    N = b.shape[-1]
    _check_rows(name, M)
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    _call(name, "grouped_sgemm", a, a.data_ptr(), gidx.data_ptr(),
          b.data_ptr(), out.data_ptr(), G, M, N, K, b.shape[0])
    return out


def typed(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[g] = a[g] (M, K) @ b[g] (K, N)`` in ``a.dtype`` (fp32 or bf16,
    fp32 accumulation, one rounding per output) (K4/K5)."""
    G, M, K = a.shape
    N = b.shape[-1]
    _check_rows(name, M)
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    _call(name, "gemm_typed", a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
          G, M, N, K, int(a.dtype == torch.bfloat16))
    return out


def rows(name: str, h: torch.Tensor, gidx: torch.Tensor,
         tables: torch.Tensor) -> torch.Tensor:
    """``out[r] = h[r] @ tables[gidx[r]]`` in ``h.dtype`` (K3)."""
    R, K = h.shape
    S, _, N = tables.shape
    out = torch.empty((R, N), dtype=h.dtype, device=h.device)
    _call(name, "row_gemm", h, h.data_ptr(), gidx.data_ptr(),
          tables.data_ptr(), out.data_ptr(), R, N, K, S,
          int(h.dtype == torch.bfloat16))
    return out


def scan(name: str, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, L: int,
         splits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 chunked scan on fp32 ``(BH, T, D)`` operands, ``splits``
    blocks per ``(b, h)`` (K6).  Returns (out (BH, T, D), s_final
    (BH, D, D)), both fp32."""
    BH, T, D = r.shape
    out = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    _call(name, "wkv6_chunked", r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
          logw.data_ptr(), u.data_ptr(), s0.data_ptr(), out.data_ptr(),
          s_out.data_ptr(), BH, T, D, L, splits)
    return out, s_out
