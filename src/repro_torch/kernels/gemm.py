"""The ctypes binding of the port's CUDA sources and the checks their
wrappers share.

``csrc/aug_gemm.cu`` serves the wide Aug-Conv products on the tensor cores
(fp32 in split TF32, bf16 in one bf16 pass): ``aug_sgemm_grouped`` (K2,
slot-indexed, fp32; :mod:`.grouped`) and ``aug_gemm_typed`` (K5 in
:mod:`.aug_gemm`: one matrix per group, fp32 or bf16), both bound through
:func:`aug`; and ``aug_sgemm_split`` (K4 in fp32, :mod:`.block_diag`), its
sum over K split into slices by :func:`tf32_splits`, bound through
:func:`morph_tf32`.  ``csrc/morph_gemm.cu`` serves the morph on the FFMA
pipe: ``morph_sgemm`` (K1, slot-indexed, fp32; :mod:`.grouped`) and
``morph_gemm_typed`` (K4 in bf16 and in small fp32 products,
:func:`morph_route`), its sum over K split into slices by
:func:`morph_splits`, bound through :func:`morph`.  ``csrc/row_gemm.cu``
has ``row_gemm`` (K3; :mod:`.grouped`: fp32 or bf16 h against fp32 or bf16
tables), its work split into column strips and per-warp slices of K by
:func:`row_splits`.
``csrc/wkv6.cu`` has K6, the RWKV-6 scan (:mod:`.wkv6`), in two forms that
:func:`scan_form` picks from: ``wkv6_chunked``, a state-column recurrence in
blocks of :func:`scan_width` columns, and ``wkv6_time_chunks``, the same
recurrence in chunks of time run in parallel and chained; both bound
through :func:`scan`.  ``csrc/wkv6_rows.cu`` has ``wkv6_rows`` (the key-row
scan of K6's gradient; :mod:`.wkv6`, in chunks of time run in parallel and
chained, as K6's time-chunked form), bound through :func:`key_rows`.
Each wrapper counts its own launches; this module
counts none.  The libraries are built at first use (:mod:`.build`); nothing
here runs at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..sharding.hints import is_dtensor
from . import build

__all__ = ["MAX_GRID_YZ", "MORPH_BK", "TF32_BK", "check_operands", "aug",
           "refuse_dtensor",
           "aug_workspace_floats", "morph", "morph_route", "morph_splits",
           "morph_tf32", "tf32_splits", "sm_count", "rows", "row_splits",
           "scan", "scan_form", "scan_smem_bytes", "scan_sync_words",
           "scan_width", "scan_widths",
           "SCAN_SPLIT", "SCAN_CHUNKS", "key_rows", "rows_chunk",
           "rows_sync_words"]

MAX_GRID_YZ = 65535
_BM = 64            # rows per block in morph_gemm.cu, at least in aug_gemm.cu
_AUG_BN = 128       # columns per block of aug_gemm.cu's fp32 kernel (grid y)
_MORPH_BN = 128     # columns per block in morph_gemm.cu
MORPH_BK = 16       # k per pipeline stage in morph_gemm.cu; slices align to it
_MORPH_RESIDENT = 3     # morph_gemm.cu blocks that fit one SM (launch bounds)
_MORPH_MIN_SLICE = 8    # k-steps per slice at least
_MORPH_FILL = 2         # k-steps a block spends filling its pipeline (STAGES - 1)
_MORPH_MAX_SPLITS = 16
# aug_gemm.cu's fp32 GEMM (split TF32), K4's fp32 route through
# aug_sgemm_split: k per stage, row tile by M, one block per SM; the modelled
# stages a block spends filling its pipeline, and the stages' worth of time
# that one slice's partial tile costs (written by the GEMM, read by the sum).
TF32_BK = 32
_TF32_FILL = 2
_TF32_PART = 2
_TF32_MAX_SPLITS = 16
_TF32_MIN_FLOP = 3e9            # morph_route: smaller fp32 products on FFMA
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
# wkv6.cu's time-chunked form: the chunk lengths scan_form picks from (it
# takes whole tiles of 16 tokens, at most 256); scan_form's thresholds.
SCAN_CHUNKS = (32, 64, 128, 256)
_SCAN_CHUNK_MIN_WARPS = 2       # columns-form consumer warps an SM
_SCAN_CHUNK_MIN_WAVES = 8       # chunk blocks per SM
_SCAN_CHUNK_MAX = 64            # longer chunks measured slower

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {   # symbol -> (library, argtypes[, restype; default int])
    # G, M, K -> floats
    "aug_workspace_floats": ("aug_gemm", [_I] * 3, ctypes.c_size_t),
    # a, gidx, b, out, ws, G, M, N, K, S, device, stream
    "aug_sgemm_grouped": ("aug_gemm", [_P] * 5 + [_I] * 6 + [_P]),
    # a, b, out, ws, G, M, N, K, bf16, device, stream
    "aug_gemm_typed": ("aug_gemm", [_P] * 4 + [_I] * 6 + [_P]),
    # a, b, out, ws, part, G, M, N, K, splits, device, stream
    "aug_sgemm_split": ("aug_gemm", [_P] * 5 + [_I] * 6 + [_P]),
    # a, gidx, b, out, ws, G, M, N, K, S, splits, kslice, device, stream
    "morph_sgemm": ("morph_gemm", [_P] * 5 + [_I] * 8 + [_P]),
    # a, b, out, ws, G, M, N, K, bf16, splits, kslice, device, stream
    "morph_gemm_typed": ("morph_gemm", [_P] * 4 + [_I] * 8 + [_P]),
    # h, gidx, tables, out, R, N, K, S, h_bf16, tables_bf16, kslice,
    # device, stream
    "row_gemm": ("row_gemm", [_P] * 4 + [_I] * 8 + [_P]),
    # r, k, v, logw, u, s0, out, s_out, BH, T, D, C, device, stream
    "wkv6_chunked": ("wkv6", [_P] * 8 + [_I] * 5 + [_P]),
    # r, k, v, logw, u, s0, out, s_out, states, sync, BH, T, D, L, device,
    # stream
    "wkv6_time_chunks": ("wkv6", [_P] * 10 + [_I] * 5 + [_P]),
    # BH, T, L -> words
    "wkv6_chunk_sync_words": ("wkv6", [_I] * 3, ctypes.c_size_t),
    # D -> bytes
    "wkv6_smem_bytes": ("wkv6", [_I]),
    # x, y, z, logw, s0, out, states, sync, BH, T, D, device, stream
    "wkv6_rows": ("wkv6_rows", [_P] * 8 + [_I] * 4 + [_P]),
    # -> L, the chunk length it was built with
    "wkv6_rows_chunk": ("wkv6_rows", []),
    # BH, T -> words
    "wkv6_rows_sync_words": ("wkv6_rows", [_I] * 2, ctypes.c_size_t),
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


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel takes plain tensors: a DTensor is refused, not gathered
    (each rank passes its own shard)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; pass each rank's local "
                        f"shard (DTensor.to_local())")


def check_operands(name: str, a: torch.Tensor, b: torch.Tensor,
                   dtypes: tuple[torch.dtype, ...]) -> None:
    """What every entry point takes: plain tensors (no DTensor), one
    device, one dtype out of ``dtypes``, contiguous, non-empty, no operand
    that requires grad (the kernels have no backward), at most
    ``MAX_GRID_YZ`` groups when 3-D."""
    refuse_dtensor(name, a, b)
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


def _tf32_tiles(G: int, M: int, N: int) -> int:
    """Output tiles of aug_gemm.cu's fp32 GEMM: 128 columns by 64 rows where
    M <= 64, else by 128."""
    nr = 128 if M > 64 else 64
    return G * -(-M // nr) * -(-N // _AUG_BN)


# Memoised like morph_splits: a pure function of a few ints.
@functools.lru_cache(maxsize=256)
def tf32_splits(G: int, M: int, N: int, K: int, sms: int) -> int:
    """How many slices of K aug_gemm.cu's split-TF32 GEMM sums separately
    for K4's ``G`` groups of ``(M, K) @ (K, N)`` on a card of ``sms`` SMs.

    1 where the output tiles give every SM one (one block fits an SM).
    Otherwise the split s that minimises the modelled time: the waves of
    blocks, ``ceil(tiles * s / sms)``, times a slice's stages of 32 k plus
    the 2 that fill the pipeline, plus 2 stages' worth for each slice's
    partial tile an SM writes and the sum reads back.  Ties go to the
    smaller s.  Only an s whose slices are all non-empty is taken.  At
    VGG-16's K4 (256, 3072) @ (3072, 3072) on 132 SMs (48 tiles, 96 stages)
    this is 5: 240 blocks of 20 stages, the last slice 16; the vlm
    provider's (960 tiles) and whisper's (564) are one slice."""
    tiles = _tf32_tiles(G, M, N)
    steps = -(-K // TF32_BK)
    if tiles >= sms:
        return 1
    best, best_cost = 1, None
    for s in range(1, min(_TF32_MAX_SPLITS, steps) + 1):
        per = -(-steps // s)
        if -(-steps // per) != s or G * s > MAX_GRID_YZ:
            continue
        cost = (-(-tiles * s // sms) * (per + _TF32_FILL)
                + (_TF32_PART * s * tiles / sms if s > 1 else 0.0))
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def morph_route(dtype: torch.dtype, G: int, M: int, N: int, K: int) -> str:
    """K4's kernel for ``G`` groups of ``(M, K) @ (K, N)`` in ``dtype``: fp32
    products of at least ``_TF32_MIN_FLOP`` take aug_gemm.cu's split-TF32
    GEMM (``"tf32"``, :func:`morph_tf32`: three TF32 passes on the tensor
    cores, 495 TFLOP/s, where FFMA tops out at 67); smaller fp32 products
    and bf16 take morph_gemm.cu's FFMA loop (``"ffma"``, :func:`morph`; no
    main path runs K4 in bf16).  Below the threshold the split form's three
    launches and split pass cost more than its tensor cores save: on an
    H100 (256, 3072) @ (3072, 3072) (4.8 GFLOP) took 0.073 ms split against
    0.121 on FFMA, (768, 1024) @ (1024, 1024) (1.6 GFLOP) 0.066 against
    0.053 (``tools/k4_probe.py routes``)."""
    if dtype != torch.float32 or 2 * G * M * N * K < _TF32_MIN_FLOP:
        return "ffma"
    return "tf32"


def morph_tf32(name: str, a: torch.Tensor, b: torch.Tensor,
               splits: int | None = None) -> torch.Tensor:
    """``out[g] = a[g] (M, K) @ b[g] (K, N)`` in fp32 on ``csrc/aug_gemm.cu``
    (K4's fp32 route): split TF32 as K5 runs it, its sum over K in
    ``splits`` slices of ``ceil(ceil(K / 32) / splits)`` stages, by default
    :func:`tf32_splits` of the shape and the card's SMs.  The device
    launches: ``a`` split into a workspace allocated here
    (:func:`aug_workspace_floats`), the GEMM, and with splits > 1 the sum of
    the slices' fp32 partials (an fp32 ``(splits, G, M, N)`` workspace
    allocated here) in slice order: two launches, or three."""
    G, M, K = a.shape
    N = b.shape[-1]
    _check_rows(name, M)
    if splits is None:
        splits = tf32_splits(G, M, N, K, sm_count(a.device))
    steps = -(-K // TF32_BK)
    per = -(-steps // max(splits, 1))
    if splits < 1 or (splits - 1) * per >= steps or G * splits > MAX_GRID_YZ:
        raise ValueError(f"{name}: {splits} slices of K = {K} leave one empty "
                         f"or exceed the grid")
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    ws = torch.empty(aug_workspace_floats(G, M, K), dtype=torch.float32,
                     device=a.device)
    part = (torch.empty((splits, G, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    _call(name, "aug_sgemm_split", a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
          ws.data_ptr(), None if part is None else part.data_ptr(), G, M, N, K,
          splits)
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


# Memoised like morph_splits: a pure function of four ints.
@functools.lru_cache(maxsize=256)
def scan_form(BH: int, T: int, D: int, sms: int) -> tuple[str, int]:
    """K6's form for ``BH`` sequences of ``T`` tokens at head size ``D`` on
    a card of ``sms`` SMs: ``("columns", C)``, the state-column recurrence
    in blocks of C columns (:func:`scan_width`), each walking all T tokens;
    or ``("chunks", L)``, the time-chunked form, a block per sequence and
    chunk of L tokens (``SCAN_CHUNKS``) owning every column.

    The columns form's blocks each run T tokens in series, so where BH
    sequences leave the card's schedulers short of warps its time grows
    with T.  The chunked form takes where the columns form would put fewer
    than ``_SCAN_CHUNK_MIN_WARPS`` consumer warps on an SM and there are at
    least ``_SCAN_CHUNK_MIN_WAVES`` chunk blocks an SM at the longest L up
    to ``_SCAN_CHUNK_MAX``: it pays a local pass, a chain of chunk states
    and a correction of each token's read-out, which the many blocks hide.
    On an H100 (``tools/k6_probe.py time``): at the prefill's (40, 384) the
    columns form took 0.026 ms, the chunked form 0.037 at best; at (40,
    1024) and (160, 128) the columns form won too; at (80, 4096) the columns
    form took 0.95-0.97 ms, the chunked form 0.395 at L = 64 (three blocks
    an SM, each keeping its chunk's read-outs in shared memory), 0.437 at
    128 (two), 0.52 at 32 and 0.59 at 256."""
    C = scan_width(BH, D, sms)
    G, CPT = SCAN_SPLIT[D]
    blocks = BH * -(-D // C)
    warps = min(blocks, sms) * (C // CPT * G // 32) / sms
    if warps >= _SCAN_CHUNK_MIN_WARPS:
        return "columns", C
    for L in sorted((L for L in SCAN_CHUNKS if L <= _SCAN_CHUNK_MAX), reverse=True):
        if BH * -(-T // L) >= _SCAN_CHUNK_MIN_WAVES * sms:
            return "chunks", L
    return "columns", C


def scan_sync_words(BH: int, T: int, L: int) -> int:
    """int32 words of the zeroed sync buffer that K6's time-chunked form
    takes for ``BH`` sequences of ``T`` tokens in chunks of ``L``: the
    library's own count, since the flags' layout is its own."""
    fn, _ = _entry("wkv6_chunk_sync_words")
    return fn(BH, T, L)


def scan_smem_bytes(D: int) -> int:
    """Bytes of shared memory a K6 block takes at head size ``D``: the
    library's own count, since the layout is its own."""
    fn, _ = _entry("wkv6_smem_bytes")
    return fn(D)


def scan(name: str, r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
         width: int | None = None, tokens: int | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 scan on fp32 ``(BH, T, D)`` operands (K6) in the form
    :func:`scan_form` picks for the shape and the card's SMs, or the one
    given: ``width`` C, the columns form in blocks of C columns (one device
    launch); ``tokens`` L, the time-chunked form in chunks of L tokens (two
    device launches: the zeroed sync words, then the kernel; the chunks'
    start states go to a workspace allocated here).  Returns (out (BH, T,
    D), s_final (BH, D, D)), both fp32."""
    BH, T, D = r.shape
    if width is not None:
        form, size = "columns", width
    elif tokens is not None:
        form, size = "chunks", tokens
    else:
        form, size = scan_form(BH, T, D, sm_count(r.device))
    out = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    ptrs = [a.data_ptr() for a in (r, k, v, logw, u, s0, out, s_out)]
    if form == "columns":
        _call(name, "wkv6_chunked", r, *ptrs, BH, T, D, size)
        return out, s_out
    nc = -(-T // size)
    states = r.new_empty(max(nc - 1, 1) * BH * D * D)
    sync = r.new_zeros(scan_sync_words(BH, T, size), dtype=torch.int32)
    _call(name, "wkv6_time_chunks", r, *ptrs, states.data_ptr(),
          sync.data_ptr(), BH, T, D, size)
    return out, s_out


def rows_chunk() -> int:
    """The key-row scan's chunk length L, a constant of ``wkv6_rows.cu``:
    the library's own, since it was built with it."""
    fn, _ = _entry("wkv6_rows_chunk")
    return fn()


def rows_sync_words(BH: int, T: int) -> int:
    """int32 words of the zeroed sync buffer that the key-row scan takes for
    ``BH`` sequences of ``T`` tokens: the library's own count, since the
    flags' layout is its own."""
    fn, _ = _entry("wkv6_rows_sync_words")
    return fn(BH, T)


def key_rows(name: str, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             logw: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """The key-row scan on fp32 ``(BH, T, D)`` operands and an fp32
    ``(BH, D, D)`` start state: ``out_t[i] = M[i, :] . z_t``, then ``M[i, :]
    = e^{logw_t[i]} M[i, :] + x_t[i] y_t``, in chunks of :func:`rows_chunk`
    tokens.  Two device launches: the zeroed sync words, then the kernel;
    the chunks' start states go to a workspace allocated here.  Returns out
    (BH, T, D) fp32."""
    BH, T, D = x.shape
    out = torch.empty_like(x)
    states = x.new_empty(max(-(-T // rows_chunk()) - 1, 1) * BH * D * D)
    sync = x.new_zeros(rows_sync_words(BH, T), dtype=torch.int32)
    _call(name, "wkv6_rows", x, *(a.data_ptr() for a in (x, y, z, logw, s0, out,
                                                          states, sync)),
          BH, T, D)
    return out
