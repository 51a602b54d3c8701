"""Gradient compression for cross-pod data parallelism, ported from
``repro.optim.compress``.

  * ``quantize_int8 / dequantize_int8`` — per-leaf symmetric int8 with an
    fp32 scale, ``max|x| / 127 + 1e-12``; ``torch.round`` rounds half to
    even as ``jnp.round`` does, so the codes equal the reference's.
  * ``ErrorFeedback`` keeps the residual so compression error accumulates
    into later steps instead of being lost, on the flat ``{leaf name:
    tensor}`` dicts of :mod:`repro_torch.optim.adamw`.

  * ``compressed_psum`` — the quantized all-reduce over one axis of a
    ``DeviceMesh`` (the "pod" axis for cross-pod DP): quantize locally ->
    int8 all-gather over the axis (a quarter of the bytes an fp32
    all-gather moves) -> dequantize and sum in rank order.  The reference
    runs it under ``shard_map``; here each rank calls it on its own tensor.
"""
from __future__ import annotations

import torch

__all__ = ["ErrorFeedback", "compressed_psum", "dequantize_int8",
           "quantize_int8"]


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


def compressed_psum(x: torch.Tensor, axis_name: str, mesh) -> torch.Tensor:
    """The sum over the ranks of ``mesh``'s axis ``axis_name`` of each
    rank's ``x`` (a DTensor counts as its local shard), with int8 on the
    wire: each rank's codes and fp32 scale are all-gathered over the axis's
    group, dequantized and added in rank order, in fp32."""
    import torch.distributed as dist

    from ..sharding.hints import is_dtensor

    xs = x.to_local() if is_dtensor(x) else x
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    q, s = quantize_int8(xs)
    s = s.reshape(1)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)        # int8 over the wire
    dist.all_gather(ss, s, group=group)
    out = dequantize_int8(qs[0], ss[0][0])
    for qi, si in zip(qs[1:], ss[1:]):
        out = out + dequantize_int8(qi, si[0])
    return out
