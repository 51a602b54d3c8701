"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064; RoPE SwiGLU RMSNorm.
Copied from ``repro.configs.phi3_mini_3p8b``.
"""
from ..models.base import ModelConfig

FULL = ModelConfig(
    name="phi3_mini_3p8b",
    family="dense",
    vocab=32_064,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    block_pattern=("attn",),
    n_groups=32,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2404.14219 (unverified tier)",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, n_groups=2, param_dtype="float32", dtype="float32",
    )
