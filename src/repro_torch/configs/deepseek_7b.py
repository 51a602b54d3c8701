"""DeepSeek-LLM 7B [arXiv:2401.02954; hf] — llama architecture.

30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400; RMSNorm,
RoPE, SwiGLU.  Copied from ``repro.configs.deepseek_7b``.
"""
from ..models.base import ModelConfig

FULL = ModelConfig(
    name="deepseek_7b",
    family="dense",
    vocab=102_400,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    block_pattern=("attn",),
    n_groups=30,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.02954 + hf:deepseek-ai/deepseek-llm-7b-base",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, n_groups=2, param_dtype="float32", dtype="float32",
    )
