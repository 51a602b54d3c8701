"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

27L d_model=2048 16H vocab=102400; MLA kv_lora=512 (qk_nope 128 + qk_rope 64,
v_head 128, q un-compressed in Lite); layer 0 dense FFN 10944; layers 1..26
MoE 2 shared + 64 routed top-6, expert d_ff=1408.  Copied from
``repro.configs.deepseek_v2_lite_16b`` (64 routed experts, as the Lite
model is published; 160 is DeepSeek-V2-236B).
"""
from ..models.base import MLACfg, MoECfg, ModelConfig

FULL = ModelConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    vocab=102_400,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,               # unused by MLA (kept for generic paths)
    head_dim=192,                # qk_nope + qk_rope
    d_ff=1408,
    prefix_pattern=("mla",),
    block_pattern=("mla_moe",),
    n_groups=26,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    mla=MLACfg(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoECfg(
        n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
        first_dense_ff=10944, capacity_factor=1.25, norm_topk=False,
    ),
    source="arXiv:2405.04434 + hf:deepseek-ai/DeepSeek-V2-Lite",
)


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, vocab=512, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=32, n_groups=2,
        mla=MLACfg(kv_lora=32, qk_nope=16, qk_rope=8, v_head=16),
        moe=MoECfg(n_routed=8, n_shared=2, top_k=2, d_ff_expert=32,
                   first_dense_ff=128, capacity_factor=1.5),
        param_dtype="float32", dtype="float32",
    )
