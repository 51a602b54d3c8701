"""RecurrentGemma 2B (Griffin) [arXiv:2402.19427; hf] — hybrid.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000;
block types (RG-LRU, RG-LRU, local-attn-2048) repeating -> 8 full triples +
(rec, rec) suffix; GeGLU; scaled+tied embeddings.
Copied from ``repro.configs.recurrentgemma_2b``.  The RG-LRU scan runs as
torch ops (the reference's is an XLA associative scan, not a kernel).
"""
from ..models.base import ModelConfig, RnnCfg

FULL = ModelConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    vocab=256_000,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    block_pattern=("rec", "rec", "local"),
    n_groups=8,
    suffix_pattern=("rec", "rec"),
    norm="rmsnorm",
    act="geglu",
    sliding_window=2048,
    scale_embedding=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    rnn=RnnCfg(d_rnn=2560, conv_width=4, c=8.0),
    source="arXiv:2402.19427 + hf:google/recurrentgemma-2b",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, n_groups=2, sliding_window=8,
        rnn=RnnCfg(d_rnn=64, conv_width=4, c=8.0),
        param_dtype="float32", dtype="float32",
    )
