"""Hand-written Hopper kernels for MoLe's morph, Aug-Conv and decode steps
and the RWKV-6 scan.

  block_diag — K4, the single-tenant (or per-group) morph
               ``x @ blockdiag(core)``
  aug_gemm   — K5, the developer's Aug-Conv ``T @ C^{ac}``
  grouped    — slot-indexed grouped GEMMs: morph + Aug-Conv of the delivery
               engine (K1, K2) and the decode logits (K3, ``csrc/row_gemm.cu``)
  ops        — the public entry points (``morph_rows``, ``aug_conv_forward``
               and their ``_batched`` forms; the engine- and decode-facing
               grouped steps with their gidx clamp), and the LM gathers
  wkv6       — K6, the RWKV-6 chunked scan (``csrc/wkv6.cu``), on the
               time-mix prefill of ``rwkv`` blocks, and its gradient
               (``wkv6_scan``: K6 on flipped operands and the key-row scan
               ``wkv6_rows``, ``csrc/wkv6_rows.cu``)
  gemm       — the ctypes binding of every entry point of ``csrc/``
               (``morph_gemm.cu``, the split-K morph kernel behind K1 and
               K4, with its split rule; ``aug_gemm.cu``, the tensor-core
               GEMM behind K2 and K5, fp32 in split TF32; a null slot-index
               pointer means slot = group index)
  ref        — plain PyTorch versions: the CPU path and the on-card yardstick
  build      — nvcc build of ``csrc/`` at first use, loaded with ctypes

``repro.kernels.dispatch`` has no counterpart: the tensor's device picks the
implementation (CUDA launches the kernel or raises; CPU runs ``ref``).
"""
from .aug_gemm import aug_gemm
from .block_diag import block_diag_matmul
from .grouped import grouped_aug_gemm, grouped_block_diag_matmul, grouped_row_gemm
from .ops import (
    aug_conv_forward,
    aug_conv_forward_batched,
    aug_conv_forward_grouped,
    aug_embed_batched,
    aug_embed_grouped,
    aug_embed_rows_grouped,
    lm_head_rows_grouped,
    morph_rows,
    morph_rows_batched,
    morph_rows_grouped,
    token_morph_batched,
    token_morph_grouped,
)
from .wkv6 import wkv6_chunked, wkv6_rows, wkv6_scan
from . import ref

__all__ = [
    "aug_gemm",
    "block_diag_matmul",
    "grouped_aug_gemm",
    "grouped_block_diag_matmul",
    "grouped_row_gemm",
    "aug_conv_forward",
    "aug_conv_forward_batched",
    "aug_conv_forward_grouped",
    "aug_embed_batched",
    "aug_embed_grouped",
    "aug_embed_rows_grouped",
    "lm_head_rows_grouped",
    "morph_rows",
    "morph_rows_batched",
    "morph_rows_grouped",
    "token_morph_batched",
    "token_morph_grouped",
    "wkv6_chunked",
    "wkv6_rows",
    "wkv6_scan",
    "ref",
]
