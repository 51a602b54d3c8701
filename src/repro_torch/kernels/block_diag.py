"""K4: the repeated-block-diagonal GEMM (provider-side morphing), on Hopper.

Replaces the Pallas kernel ``block_diag_matmul``
(``repro/kernels/block_diag.py:45``): ``y = x @ blockdiag(core x kappa)``
without materialising the block-diagonal matrix.  ``x (R, kappa*q)`` viewed
as ``(R*kappa, q)`` times the ``(q, q)`` core is that product, so
:func:`block_diag_matmul` runs one GEMM on that view with one group (or,
for ``x (G, B, kappa*q)`` and ``cores (G, q, q)``, one core per group: the
reference's ``vmap`` over the group axis as a grid axis).  The kernel is
:func:`.gemm.morph_route`'s for the dtype:

  * fp32 (all the main paths' shapes): the split-TF32 GEMM of
    ``csrc/aug_gemm.cu`` (K5's, entry point ``aug_sgemm_split``,
    :func:`.gemm.morph_tf32`): each operand a sum of two TF32 values, three
    passes on the tensor cores, a fresh accumulator per 32 k added in fp32;
    the sum over q split into slices by :func:`.gemm.tf32_splits` where the
    output tiles leave SMs idle;
  * bf16, and fp32 products too small for the split form to pay: the FFMA
    morph kernel (``morph_gemm_typed`` of ``csrc/morph_gemm.cu``, K1's
    kernel, :func:`.gemm.morph`), split by :func:`.gemm.morph_splits`.

fp32 accumulation, each output rounded once to the operand dtype; every
ragged edge is masked, so any shape runs (no tileability route).

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref.py``.
Launches are counted in ``block_diag_matmul.launches``.  The kernel has no
backward, like the Pallas kernel: an operand that requires grad raises on
every device.
"""
from __future__ import annotations

import torch

from . import gemm, ref

__all__ = ["block_diag_matmul"]

_DTYPES = (torch.float32, torch.bfloat16)


def block_diag_matmul(
    x: torch.Tensor,        # (R, F) or (G, B, F) with F = kappa * q
    core: torch.Tensor,     # (q, q), or (G, q, q): one core per group
    kappa: int,
) -> torch.Tensor:
    """``reshape(x, (..., kappa, q)) @ core``, per group when 3-D."""
    name = "block_diag_matmul"
    gemm.check_operands(name, x, core, _DTYPES)
    batched = x.dim() == 3
    q = core.shape[-1]
    if (x.dim() not in (2, 3) or core.dim() != x.dim()
            or core.shape[-2] != q or x.shape[-1] != kappa * q
            or (batched and core.shape[0] != x.shape[0])):
        raise ValueError(
            f"{name}: x {tuple(x.shape)} is not kappa={kappa} blocks of the "
            f"core {tuple(core.shape)}"
        )
    if x.device.type == "cpu":
        if batched:
            return ref.block_diag_matmul_batched_ref(x, core, kappa)
        return ref.block_diag_matmul_ref(x, core, kappa)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    G = x.shape[0] if batched else 1
    a, b = x.view(G, -1, q), core.view(G, q, q)
    if gemm.morph_route(x.dtype, *a.shape, q) == "tf32":
        out = gemm.morph_tf32(name, a, b)
    else:
        out = gemm.morph(name, a, None, b)
    block_diag_matmul.launches += 1
    return out.view_as(x)


block_diag_matmul.launches = 0
