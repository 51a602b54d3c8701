"""Hand-written Hopper kernels for MoLe's delivery hot path.

  grouped  — slot-indexed grouped GEMMs (morph + Aug-Conv), one CUDA C++
             kernel in ``csrc/grouped_gemm.cu`` behind two wrappers
  ops      — the engine-facing entry points (gidx clamp)
  ref      — plain PyTorch versions: the CPU path and the on-card yardstick
  build    — nvcc build of ``csrc/`` at first use, loaded with ctypes

``repro.kernels.dispatch`` has no counterpart: the tensor's device picks the
implementation (CUDA launches the kernel or raises; CPU runs ``ref``).
"""
from .grouped import grouped_aug_gemm, grouped_block_diag_matmul
from .ops import aug_conv_forward_grouped, morph_rows_grouped
from . import ref

__all__ = [
    "grouped_aug_gemm",
    "grouped_block_diag_matmul",
    "aug_conv_forward_grouped",
    "morph_rows_grouped",
    "ref",
]
