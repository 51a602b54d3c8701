"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified].

100L total: 80 self-attention (d_model=8192 64H kv=8 d_ff=28672) + 20 gated
cross-attention layers (every 5th layer) over stubbed patch embeddings;
vocab=128256.  The vision tower is a stub: the data pipeline provides
precomputed patch embeddings (B, 1024, 7680), which ``frontend_proj``
takes to d_model before the cross layers attend to them.
Copied from ``repro.configs.llama32_vision_90b``.
"""
from ..models.base import FrontendCfg, ModelConfig

FULL = ModelConfig(
    name="llama32_vision_90b",
    family="vlm",
    vocab=128_256,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    n_groups=20,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=500_000.0,
    frontend=FrontendCfg(kind="vision", d_in=7680, n_tokens=1024, cross_gated=True),
    source="hf:meta-llama/Llama-3.2-90B-Vision (unverified tier)",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, n_groups=2,
        frontend=FrontendCfg(kind="vision", d_in=48, n_tokens=16, cross_gated=True),
        param_dtype="float32", dtype="float32",
    )
