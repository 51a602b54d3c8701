"""Gemma-2 27B [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 — alternating
local(4096)/global attention, attn-logit softcap 50, final softcap 30,
pre+post RMSNorm, GeGLU, tied + scaled embeddings, query scale (d/H)^-0.5.
Copied from ``repro.configs.gemma2_27b``.
"""
from ..models.base import ModelConfig

FULL = ModelConfig(
    name="gemma2_27b",
    family="dense",
    vocab=256_000,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    block_pattern=("local", "global"),
    n_groups=23,
    norm="rmsnorm",
    act="geglu",
    post_norm=True,
    sliding_window=4096,
    attn_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/n_heads
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embedding=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2408.00118 + hf:google/gemma-2-27b",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, n_groups=2, sliding_window=8, attn_scale=(64 / 4) ** -0.5,
        param_dtype="float32", dtype="float32",
    )
