"""Config registry of the port: the architectures it runs so far.

``get_config(name)`` / ``get_smoke_config(name)``.  The port runs all ten
architectures of the reference's registry (``repro.configs``): dense
attention (deepseek_7b, phi3_mini_3p8b, command_r_35b and gemma2_27b,
whose local layers attend in a sliding window); RWKV-6 (rwkv6_3b);
fine-grained MoE (deepseek_moe_16b, and deepseek_v2_lite_16b with
multi-head latent attention); the hybrid RG-LRU / local-attention stack
(recurrentgemma_2b); the vision-language stack with tanh-gated
cross-attention over a stubbed patch stream (llama32_vision_90b); and the
audio encoder-decoder over a stubbed frame stream (whisper_tiny).  Every
other name raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from ..models.base import ModelConfig

ARCHS: tuple[str, ...] = (
    "command_r_35b", "gemma2_27b", "deepseek_7b", "deepseek_moe_16b",
    "deepseek_v2_lite_16b", "llama32_vision_90b", "phi3_mini_3p8b",
    "recurrentgemma_2b", "rwkv6_3b", "whisper_tiny",
)


def _module(name: str):
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is unknown or not ported; the port runs {ARCHS}"
        )
    return importlib.import_module(f".{name}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ARCHS", "get_config", "get_smoke_config"]
