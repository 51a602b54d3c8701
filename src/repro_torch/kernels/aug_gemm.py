"""K5: the developer-side Aug-Conv GEMM ``F' = T @ C^{ac}``, on Hopper.

Replaces the Pallas kernel ``aug_gemm`` (``repro/kernels/aug_gemm.py:41``):
the dense product the developer runs every forward step once MoLe has
replaced the first conv layer (paper §3.3, eq. 5), morphed rows
``T (B, alpha m^2)`` against the fused matrix ``C^{ac} (alpha m^2, beta
n^2)``.  :func:`aug_gemm` launches the ``aug_gemm_typed`` entry point of
``csrc/aug_gemm.cu`` (:func:`.gemm.aug`) with one group (or, for ``t (G,
B, K)`` and ``c_acs (G, K, N)``, one matrix per group: the reference's
``vmap`` as a grid axis).  fp32 or bf16 operands of one dtype, on the
tensor cores: fp32 in split TF32 (each operand as a sum of two TF32 values,
three passes), bf16 in one pass; fp32 accumulation, each output rounded
once; every ragged edge is masked, so any shape runs.

The device of the tensors picks the implementation: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version in ``ref.py``.
Launches are counted in ``aug_gemm.launches``.  The kernel has no backward,
like the Pallas kernel: an operand that requires grad raises on every
device (``models.cnn.apply`` passes ``C^{ac}`` detached, as the reference
passes it through ``stop_gradient``).
"""
from __future__ import annotations

import torch

from . import gemm, ref

__all__ = ["aug_gemm"]

_DTYPES = (torch.float32, torch.bfloat16)


def aug_gemm(
    t: torch.Tensor,        # (B, K) or (G, B, K) morphed rows
    c_ac: torch.Tensor,     # (K, N), or (G, K, N): one matrix per group
) -> torch.Tensor:
    """``t @ c_ac``, per group when 3-D, accumulated in fp32."""
    name = "aug_gemm"
    gemm.check_operands(name, t, c_ac, _DTYPES)
    batched = t.dim() == 3
    if (t.dim() not in (2, 3) or c_ac.dim() != t.dim()
            or c_ac.shape[-2] != t.shape[-1]
            or (batched and c_ac.shape[0] != t.shape[0])):
        raise ValueError(
            f"{name}: t {tuple(t.shape)} does not match c_ac {tuple(c_ac.shape)}"
        )
    if t.device.type == "cpu":
        if batched:
            return ref.aug_gemm_batched_ref(t, c_ac)
        return ref.aug_gemm_ref(t, c_ac)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")
    G = t.shape[0] if batched else 1
    K, N = c_ac.shape[-2:]
    out = gemm.aug(name, t.view(G, -1, K), None, c_ac.view(G, K, N))
    aug_gemm.launches += 1
    return out.view(*t.shape[:-1], N)


aug_gemm.launches = 0
