"""Whisper-style encoder-decoder (audio family) on PyTorch.

Ported from ``repro.models.whisper``.  The conv frontend is a stub: the
batch carries precomputed frame embeddings ``frames: (B, n_frames, d_in)``.
The encoder is ``enc_proj``, then ``frontend.enc_layers`` bidirectional
``bidir`` blocks (RoPE on Q and K over the frame positions, no mask), then
``enc_norm`` (``cfg.norm``).  The decoder is the generic stack of
``("dec",)`` layers (self-attention, cross-attention over the encoder's
output, FFN) under ``params["dec"]``.

The reference scans its encoder over blocks stacked on a leading
``enc_layers`` axis (``enc_blocks["b0"]``); here ``params["enc_blocks"]``
is a list of per-layer dicts run in a loop, each block recomputed in the
backward under ``remat``, as :func:`repro_torch.models.stack.apply_stack`
does for the decoder.  Caches are ``{"dec": <the decoder's caches>}``;
each ``dec`` layer's cross caches hold the K/V of the ``n_tokens`` frames,
written by the prefill and read by decode, which never sees the frames.
"""
from __future__ import annotations

import torch

from ..sharding.spmd import in_use
from .base import ModelConfig, ParamDef
from . import blocks as B
from . import layers as L
from . import stack as S

__all__ = ["whisper_schema", "whisper_cache_schema", "encode", "decode_step"]


def whisper_schema(cfg: ModelConfig) -> dict:
    fe = cfg.frontend
    return {
        "enc_proj": ParamDef((fe.d_in, cfg.d_model), (None, "embed"),
                             scale=0.02),
        "enc_blocks": [S.block_schema(cfg, "bidir")
                       for _ in range(fe.enc_layers)],
        "enc_norm": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
        "dec": S.model_schema(cfg),
    }


def whisper_cache_schema(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return {"dec": S.model_cache_schema(cfg, batch, max_len)}


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = False) -> torch.Tensor:
    """The encoder's output (B, n_frames, d_model) in the activation type:
    the cross layers' context."""
    h = torch.matmul(frames.to(cfg.adtype), params["enc_proj"])
    rs = B.RunState(mode="full")
    remat = remat and torch.is_grad_enabled()
    for p in params["enc_blocks"]:
        if remat:
            h = S._recomputed(
                lambda x, p=p: S.apply_block(in_use(p), x, cfg, rs, None,
                                             "bidir")[0],
                h)
        else:
            h, _ = S.apply_block(in_use(p), h, cfg, rs, None, "bidir")
    return L.norm(h, params["enc_norm"], cfg.norm)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, t,
                caches: dict):
    """One decoder token at position ``t`` against the caches."""
    logits, dec_caches = S.decode_step(params["dec"], cfg, token, t,
                                       caches["dec"])
    return logits, {"dec": dec_caches}
