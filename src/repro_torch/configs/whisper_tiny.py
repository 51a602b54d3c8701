"""Whisper-tiny [arXiv:2212.04356; unverified] — audio encoder-decoder.

4+4L d_model=384 6H d_ff=1536 vocab=51865; the conv frontend is a stub:
the data pipeline provides precomputed frame embeddings (B, 1500, 384),
which ``enc_proj`` takes into a bidirectional encoder of ``enc_layers``
layers; the decoder's ``dec`` layers cross-attend to its output.  Benchmark
shapes apply ``seq_len`` to the decoder; the encoder is fixed at 1500
frames.  Copied from ``repro.configs.whisper_tiny``.
"""
from ..models.base import FrontendCfg, ModelConfig

FULL = ModelConfig(
    name="whisper_tiny",
    family="audio",
    vocab=51_865,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    block_pattern=("dec",),
    n_groups=4,
    norm="layernorm",
    act="gelu",
    rope_theta=10_000.0,
    dense_attn_max_seq=2048,   # encoder's 1500-frame attention stays unfused
    frontend=FrontendCfg(kind="audio", d_in=384, n_tokens=1500,
                         cross_gated=False, enc_layers=4),
    source="arXiv:2212.04356 (unverified tier)",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, n_groups=2,
        frontend=FrontendCfg(kind="audio", d_in=64, n_tokens=24,
                             cross_gated=False, enc_layers=2),
        param_dtype="float32", dtype="float32",
    )
