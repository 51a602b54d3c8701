"""The ctypes binding of the port's CUDA sources and the checks their
wrappers share.

``csrc/aug_gemm.cu`` serves the wide Aug-Conv products on the tensor cores
(fp32 in split TF32, bf16 in one bf16 pass): ``aug_sgemm_grouped`` (K2,
slot-indexed, fp32; :mod:`.grouped`) and ``aug_gemm_typed`` (K5 in
:mod:`.aug_gemm`: one matrix per group, fp32 or bf16), both bound through
:func:`aug`.  ``csrc/morph_gemm.cu`` serves the morph, narrow and deep:
``morph_sgemm`` (K1, slot-indexed, fp32; :mod:`.grouped`) and
``morph_gemm_typed`` (K4 in :mod:`.block_diag`, fp32 or bf16), its sum over
K split into slices by :func:`morph_splits`.  ``csrc/row_gemm.cu`` has
``row_gemm`` (K3; :mod:`.grouped`: fp32 or bf16 h against fp32 or bf16
tables), its work split into column strips and per-warp slices of K by
:func:`row_splits`.
``csrc/wkv6.cu`` has ``wkv6_chunked`` (K6, the RWKV-6 scan as a
state-column recurrence; :mod:`.wkv6`), its block width chosen by
:func:`scan_width`; ``csrc/wkv6_rows.cu`` has ``wkv6_rows`` (the key-row
scan of K6's gradient; :mod:`.wkv6`), bound through :func:`key_rows`.
Each wrapper counts its own launches; this module
counts none.  The libraries are built at first use (:mod:`.build`); nothing
here runs at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["MAX_GRID_YZ", "MORPH_BK", "check_operands", "aug",
           "aug_workspace_floats", "morph", "morph_splits", "sm_count", "rows",
           "row_splits", "scan", "scan_smem_bytes", "scan_width",
           "scan_widths", "SCAN_SPLIT", "key_rows"]

MAX_GRID_YZ = 65535
_BM = 64            # rows per block in morph_gemm.cu, at least in aug_gemm.cu
_AUG_BN = 128       # columns per block of aug_gemm.cu's fp32 kernel (grid y)
_MORPH_BN = 128     # columns per block in morph_gemm.cu
MORPH_BK = 16       # k per pipeline stage in morph_gemm.cu; slices align to it
_MORPH_RESIDENT = 3     # morph_gemm.cu blocks that fit one SM (launch bounds)
_MORPH_MIN_SLICE = 8    # k-steps per slice at least
_MORPH_FILL = 2         # k-steps a block spends filling its pipeline (STAGES - 1)
_MORPH_MAX_SPLITS = 16
# row_gemm.cu (K3): a block of _ROW_WARPS warps takes one row and one strip
# of _ROW_STRIP_BYTES of each table row; its warps split K into slices of
# whole batches of _ROW_U table rows.
_ROW_WARPS = 8
_ROW_STRIP_BYTES = 512
_ROW_U = 4
# wkv6.cu's Split: per head size, the threads per state column (G) and the
# columns per thread (CPT) it is compiled for; its consumer threads per
# block at most.
SCAN_SPLIT = {16: (4, 1), 64: (16, 4)}
_SCAN_MAX_THREADS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {   # symbol -> (library, argtypes[, restype; default int])
    # G, M, K -> floats
    "aug_workspace_floats": ("aug_gemm", [_I] * 3, ctypes.c_size_t),
    # a, gidx, b, out, ws, G, M, N, K, S, device, stream
    "aug_sgemm_grouped": ("aug_gemm", [_P] * 5 + [_I] * 6 + [_P]),
    # a, b, out, ws, G, M, N, K, bf16, device, stream
    "aug_gemm_typed": ("aug_gemm", [_P] * 4 + [_I] * 6 + [_P]),
    # a, gidx, b, out, ws, G, M, N, K, S, splits, kslice, device, stream
    "morph_sgemm": ("morph_gemm", [_P] * 5 + [_I] * 8 + [_P]),
    # a, b, out, ws, G, M, N, K, bf16, splits, kslice, device, stream
    "morph_gemm_typed": ("morph_gemm", [_P] * 4 + [_I] * 8 + [_P]),
    # h, gidx, tables, out, R, N, K, S, h_bf16, tables_bf16, kslice,
    # device, stream
    "row_gemm": ("row_gemm", [_P] * 4 + [_I] * 8 + [_P]),
    # r, k, v, logw, u, s0, out, s_out, BH, T, D, C, device, stream
    "wkv6_chunked": ("wkv6", [_P] * 8 + [_I] * 5 + [_P]),
    # D -> bytes
    "wkv6_smem_bytes": ("wkv6", [_I]),
    # x, y, z, logw, s0, out, BH, T, D, device, stream
    "wkv6_rows": ("wkv6_rows", [_P] * 6 + [_I] * 4 + [_P]),
}


@functools.cache
def _entry(symbol: str):
    lib_name, argtypes, *restype = _ENTRIES[symbol]
    lib = build.load(lib_name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = restype[0] if restype else ctypes.c_int
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


def aug_workspace_floats(G: int, M: int, K: int) -> int:
    """fp32 floats of the split-T workspace that ``csrc/aug_gemm.cu``'s
    fp32 GEMM takes for ``G`` groups of ``(M, K)`` operands: the library's
    own count, since the layout follows its tiles."""
    fn, _ = _entry("aug_workspace_floats")
    return fn(G, M, K)


def aug(name: str, a: torch.Tensor, gidx: torch.Tensor | None,
        b: torch.Tensor) -> torch.Tensor:
    """``out[g] = a[g] (M, K) @ b[slot(g)] (K, N)`` on ``csrc/aug_gemm.cu``.
    With ``gidx`` (K2): fp32, ``slot = clamp(gidx[g], 0, S - 1)``.  Without
    (K5): slot = g, fp32 or bf16.  fp32 runs in split TF32 (three TF32
    passes): two device launches, ``a`` split into an fp32 workspace
    allocated here (:func:`aug_workspace_floats`), then the GEMM.  bf16 runs
    one bf16 pass in one launch.  fp32 accumulation, one rounding per
    output."""
    G, M, K = a.shape
    N = b.shape[-1]
    _check_rows(name, M)
    if -(-N // _AUG_BN) > MAX_GRID_YZ:
        raise ValueError(f"{name}: {N} columns exceed the grid limit")
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    ws = (torch.empty(aug_workspace_floats(G, M, K), dtype=torch.float32,
                      device=a.device) if a.dtype == torch.float32 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    if gidx is None:
        _call(name, "aug_gemm_typed", a, a.data_ptr(), b.data_ptr(),
              out.data_ptr(), ws_ptr, G, M, N, K, int(a.dtype == torch.bfloat16))
    else:
        _call(name, "aug_sgemm_grouped", a, a.data_ptr(), gidx.data_ptr(),
              b.data_ptr(), out.data_ptr(), ws_ptr, G, M, N, K, b.shape[0])
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA ``device`` (``multi_processor_count``, which the
    CUDA runtime reads from ``cudaDevAttrMultiProcessorCount``)."""
    return _sm_count(device.index)


def _kslice(K: int, splits: int) -> int:
    """``ceil(ceil(K / BK) / splits) * BK``, the length of every slice but
    the last; raises if ``splits`` would leave a slice empty."""
    steps = -(-K // MORPH_BK)
    per = -(-steps // max(splits, 1)) * MORPH_BK
    if splits < 1 or (splits - 1) * per >= K:
        raise ValueError(f"morph: {splits} slices of K = {K} leave one empty")
    return per


# Memoised: the rule is a pure function of a few ints, and its loop would
# otherwise cost each call about as much host time as the rest of the
# wrapper.
@functools.lru_cache(maxsize=256)
def morph_splits(G: int, M: int, N: int, K: int, sms: int) -> int:
    """How many slices of K the morph kernel sums separately, for ``G``
    groups of ``(M, K) @ (K, N)`` on a card of ``sms`` SMs.

    1 where the output tiles fill the card by themselves (three blocks on
    every SM) or K < 256 (two slices of 8 k-steps of 16).  Otherwise the
    split s that minimises the modelled time of the busiest SM: its blocks,
    ``ceil(tiles * s / sms)`` but at least 2 (one block of 4 warps leaves an
    SM half busy), times the k-steps of one slice plus the 2 that fill the
    pipeline.  Ties go to the smaller s, which writes and adds fewer partial
    sums.  Only an s whose slices are all non-empty is taken.  At the main
    shapes (96 tiles, K = 3072, 132 SMs) this is 4: 384 blocks of 48 k-steps.
    """
    tiles = G * -(-M // _BM) * -(-N // _MORPH_BN)
    steps = -(-K // MORPH_BK)
    if tiles >= _MORPH_RESIDENT * sms:
        return 1
    best, best_cost = 1, None
    for s in range(1, min(_MORPH_MAX_SPLITS,
                          K // (_MORPH_MIN_SLICE * MORPH_BK)) + 1):
        per = -(-steps // s)
        if -(-steps // per) != s:
            continue
        cost = max(2, -(-tiles * s // sms)) * (per + _MORPH_FILL)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def morph(name: str, a: torch.Tensor, gidx: torch.Tensor | None,
          b: torch.Tensor, splits: int | None = None) -> torch.Tensor:
    """``out[g] = a[g] (M, K) @ b[slot(g)] (K, N)`` on ``csrc/morph_gemm.cu``
    with K summed in ``splits`` slices of :func:`_kslice` each, the last
    taking the rest; by default :func:`morph_splits` of the shape and the
    card's SMs.  With ``gidx`` (K1): fp32, ``slot = clamp(gidx[g], 0, S -
    1)``.  Without (K4): slot = g, fp32 or bf16 (fp32 accumulation, one
    rounding per output).  With splits > 1 the partial sums go to an fp32
    ``(splits, G, M, N)`` workspace allocated here, and the call is two
    device launches: the tiles, then their sum in slice order."""
    G, M, K = a.shape
    N = b.shape[-1]
    _check_rows(name, M)
    if splits is None:
        splits = morph_splits(G, M, N, K, sm_count(a.device))
    kslice = _kslice(K, splits)
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    ws = (torch.empty((splits, G, M, N), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    if gidx is None:
        _call(name, "morph_gemm_typed", a, a.data_ptr(), b.data_ptr(),
              out.data_ptr(), ws_ptr, G, M, N, K,
              int(a.dtype == torch.bfloat16), splits, kslice)
    else:
        _call(name, "morph_sgemm", a, a.data_ptr(), gidx.data_ptr(),
              b.data_ptr(), out.data_ptr(), ws_ptr, G, M, N, K, b.shape[0],
              splits, kslice)
    return out


def row_splits(R: int, K: int, N: int, table_bytes: int) -> tuple[int, int]:
    """K3's split of the work for ``R`` rows of ``K`` against tables of
    ``N`` columns of ``table_bytes`` bytes an entry: ``(strips, kslice)``.

    A block takes one row and one strip of 512 bytes of each table row (128
    fp32 or 256 bf16 columns), so the grid is ``(strips, R)``; its 8 warps
    take slices of ``kslice`` table rows of K, a multiple of the kernel's
    batch of 4, the last taking the rest (warps past K idle), and add their
    sums in warp order.  At phi3_mini_3p8b's shape (R 4, K 3072, N 32064)
    that is 504 blocks on bf16 tables and 1,004 on fp32 ones, at
    deepseek_7b's (K 4096, N 102400) 1,600 and 3,200: every one of 132 SMs
    busy, 4 blocks an SM resident."""
    strips = -(-N // (_ROW_STRIP_BYTES // table_bytes))
    per_warp = -(-K // _ROW_WARPS)
    return strips, -(-per_warp // _ROW_U) * _ROW_U


def rows(name: str, h: torch.Tensor, gidx: torch.Tensor,
         tables: torch.Tensor) -> torch.Tensor:
    """``out[r] = h[r] (K,) @ round_to(h.dtype, tables[slot(r)]) (K, N)``
    on ``csrc/row_gemm.cu`` (K3), ``slot = clamp(gidx[r], 0, S - 1)``; h in
    fp32 or bf16, tables in fp32 or bf16; fp32 sums, one rounding to
    ``h.dtype``; one launch, split by :func:`row_splits`."""
    R, K = h.shape
    S, _, N = tables.shape
    _, kslice = row_splits(R, K, N, tables.element_size())
    out = torch.empty((R, N), dtype=h.dtype, device=h.device)
    _call(name, "row_gemm", h, h.data_ptr(), gidx.data_ptr(),
          tables.data_ptr(), out.data_ptr(), R, N, K, S,
          int(h.dtype == torch.bfloat16), int(tables.dtype == torch.bfloat16),
          kslice)
    return out


def scan_widths(D: int) -> list[int]:
    """The block widths C (columns) K6 takes at head size ``D``, split as
    ``SCAN_SPLIT[D] = (G, CPT)``: C <= D (the last block of a sequence
    takes the rest), CPT divides C, and the block's ``C / CPT * G``
    consumer threads are whole warps, at most 256."""
    G, CPT = SCAN_SPLIT[D]
    return [c for c in range(CPT, D + 1, CPT)
            if c // CPT * G % 32 == 0 and c // CPT * G <= _SCAN_MAX_THREADS]


# Memoised like morph_splits: a pure function of three ints.
@functools.lru_cache(maxsize=256)
def scan_width(BH: int, D: int, sms: int) -> int:
    """The block width C for K6 on ``BH`` sequences of head size ``D`` on
    a card of ``sms`` SMs: a block owns C columns of one sequence (the last
    block of a sequence the rest), each column's rows split over G threads
    that hold CPT columns each (``SCAN_SPLIT[D]``).

    C is the width that minimises, in order: the columns on the busiest
    warp scheduler (its SM's blocks' consumer warps spread over 4
    schedulers, as many blocks on the busiest SM as ``ceil(blocks /
    sms)``), the columns on the busiest SM (shared-memory traffic), and the
    blocks (each loads and prepares its sequence's whole r, k, logw and v).
    At BH = 40, D = 64 on 132 SMs: C = 24, 120 blocks of 3 consumer warps,
    8 columns a scheduler (no width gets below 8: a warp holds 8 columns)."""
    G, CPT = SCAN_SPLIT[D]

    def cost(c: int) -> tuple[int, int, int]:
        blocks = BH * -(-D // c)
        warps = c // CPT * G // 32
        per_sm = -(-blocks // sms)
        return -(-per_sm * warps // 4) * (c // warps), per_sm * c, blocks

    return min(scan_widths(D), key=cost)


def scan_smem_bytes(D: int) -> int:
    """Bytes of shared memory a K6 block takes at head size ``D``: the
    library's own count, since the layout is its own."""
    fn, _ = _entry("wkv6_smem_bytes")
    return fn(D)


def scan(name: str, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
         width: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 scan on fp32 ``(BH, T, D)`` operands as a state-column
    recurrence (K6), blocks of ``width`` columns, by default
    :func:`scan_width` of the shape and the card's SMs.  One device
    launch.  Returns (out (BH, T, D), s_final (BH, D, D)), both fp32."""
    BH, T, D = r.shape
    C = width or scan_width(BH, D, sm_count(r.device))
    out = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    _call(name, "wkv6_chunked", r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
          logw.data_ptr(), u.data_ptr(), s0.data_ptr(), out.data_ptr(),
          s_out.data_ptr(), BH, T, D, C)
    return out, s_out


def key_rows(name: str, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             logw: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """The key-row scan on fp32 ``(BH, T, D)`` operands and an fp32
    ``(BH, D, D)`` start state: ``out_t[i] = M[i, :] . z_t``, then ``M[i, :]
    = e^{logw_t[i]} M[i, :] + x_t[i] y_t``.  One device launch.  Returns out
    (BH, T, D) fp32."""
    BH, T, D = x.shape
    out = torch.empty_like(x)
    _call(name, "wkv6_rows", x, x.data_ptr(), y.data_ptr(), z.data_ptr(),
          logw.data_ptr(), s0.data_ptr(), out.data_ptr(), BH, T, D)
    return out
