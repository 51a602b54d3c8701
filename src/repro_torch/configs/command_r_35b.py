"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias,
parallel attention+FFN block with a single shared input LayerNorm, tied
embeddings, RoPE theta 8e6.  Copied from ``repro.configs.command_r_35b``.
"""
from ..models.base import ModelConfig

FULL = ModelConfig(
    name="command_r_35b",
    family="dense",
    vocab=256_000,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    block_pattern=("attn",),
    n_groups=40,
    norm="layernorm",
    act="swiglu",
    parallel_block=True,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01 (unverified tier)",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, n_groups=2, param_dtype="float32", dtype="float32",
    )
