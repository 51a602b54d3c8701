"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf] — attention-free SSM family.

32L d_model=2560 d_ff=8960 vocab=65536; heads of 64 with data-dependent
per-channel decay; time-mix via chunked linear attention + channel-mix.
Copied from ``repro.configs.rwkv6_3b``.  On the card the time-mix prefill
runs the chunked scan as K6 (``kernels.wkv6``) at ``chunk``;
``subchunk`` selects an XLA form of the reference that the port does not
carry (K6 replaces both of the reference's forms).
"""
from ..models.base import ModelConfig, RwkvCfg

FULL = ModelConfig(
    name="rwkv6_3b",
    family="ssm",
    vocab=65_536,
    d_model=2560,
    n_heads=40,                 # d_model / rwkv.head_dim
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    block_pattern=("rwkv",),
    n_groups=32,
    norm="layernorm",
    act="swiglu",               # unused by rwkv blocks (channel-mix is fixed)
    rwkv=RwkvCfg(head_dim=64, chunk=128, subchunk=0, ddlerp_rank=32, decay_rank=64),
    source="arXiv:2404.05892 + hf:RWKV/rwkv-6-world-3b",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, n_groups=2,
        rwkv=RwkvCfg(head_dim=16, chunk=4, ddlerp_rank=8, decay_rank=16),
        param_dtype="float32", dtype="float32",
    )
