"""DeepSeekMoE 16B [arXiv:2401.06066; hf].

28L d_model=2048 16H (kv=16) vocab=102400; layer 0 has a dense FFN
(d_ff=10944); layers 1..27 are fine-grained MoE: 2 shared + 64 routed
experts, top-6, expert d_ff=1408.  Copied from
``repro.configs.deepseek_moe_16b``.
"""
from ..models.base import MoECfg, ModelConfig

FULL = ModelConfig(
    name="deepseek_moe_16b",
    family="moe",
    vocab=102_400,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                  # expert width (used via moe.d_ff_expert)
    prefix_pattern=("attn",),   # dense first layer
    block_pattern=("attn_moe",),
    n_groups=27,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    moe=MoECfg(
        n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
        first_dense_ff=10944, capacity_factor=1.25, norm_topk=False,
    ),
    source="arXiv:2401.06066 + hf:deepseek-ai/deepseek-moe-16b-base",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, n_groups=2,
        moe=MoECfg(n_routed=8, n_shared=2, top_k=2, d_ff_expert=32,
                   first_dense_ff=128, capacity_factor=1.5),
        param_dtype="float32", dtype="float32",
    )
