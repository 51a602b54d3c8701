"""Gradient compression for cross-pod data parallelism: the local half,
ported from ``repro.optim.compress``.

  * ``quantize_int8 / dequantize_int8`` — per-leaf symmetric int8 with an
    fp32 scale, ``max|x| / 127 + 1e-12``; ``torch.round`` rounds half to
    even as ``jnp.round`` does, so the codes equal the reference's.
  * ``ErrorFeedback`` keeps the residual so compression error accumulates
    into later steps instead of being lost, on the flat ``{leaf name:
    tensor}`` dicts of :mod:`repro_torch.optim.adamw`.

The reference's ``compressed_psum`` (the int8 all-gather over a mesh axis)
is a collective and arrives with the port's sharding.
"""
from __future__ import annotations

import torch

__all__ = ["ErrorFeedback", "dequantize_int8", "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 codes in [-127, 127] and a 0-dim fp32 scale."""
    x32 = x.float()
    scale = torch.max(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class ErrorFeedback:
    """Residual accumulator: compress(g + e); e' = (g + e) - decompressed."""

    @staticmethod
    def init(grads: dict) -> dict:
        return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for n, g in grads.items()}

    @staticmethod
    def compress(grads: dict, residual: dict) -> tuple[dict, dict]:
        """``(decompressed, new residual)``, each keyed as ``grads``."""
        out, res = {}, {}
        for n, g in grads.items():
            target = g.float() + residual[n]
            deq = dequantize_int8(*quantize_int8(target))
            out[n], res[n] = deq, target - deq
        return out, res
