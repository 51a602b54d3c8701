"""Hand-written Hopper kernels for MoLe's delivery hot path.

  grouped  — slot-indexed grouped GEMMs: morph + Aug-Conv (one CUDA C++
             kernel in ``csrc/grouped_gemm.cu`` behind two wrappers) and
             the decode logits (``csrc/row_gemm.cu``)
  ops      — the engine- and decode-facing entry points (gidx clamp), and
             the LM gathers
  ref      — plain PyTorch versions: the CPU path and the on-card yardstick
  build    — nvcc build of ``csrc/`` at first use, loaded with ctypes

``repro.kernels.dispatch`` has no counterpart: the tensor's device picks the
implementation (CUDA launches the kernel or raises; CPU runs ``ref``).
"""
from .grouped import grouped_aug_gemm, grouped_block_diag_matmul, grouped_row_gemm
from .ops import (
    aug_conv_forward_grouped,
    aug_embed_grouped,
    aug_embed_rows_grouped,
    lm_head_rows_grouped,
    morph_rows_grouped,
    token_morph_grouped,
)
from . import ref

__all__ = [
    "grouped_aug_gemm",
    "grouped_block_diag_matmul",
    "grouped_row_gemm",
    "aug_conv_forward_grouped",
    "aug_embed_grouped",
    "aug_embed_rows_grouped",
    "lm_head_rows_grouped",
    "morph_rows_grouped",
    "token_morph_grouped",
    "ref",
]
