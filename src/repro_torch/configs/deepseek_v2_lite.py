"""deepseek-v2-lite-16b  [moe] 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MoE 64e top-6, 2 shared, MLA kv_lora=512. [arXiv:2405.04434]

First layer dense (d_ff 10944), layers 2..27 MoE. MLA: q full-rank (lite has
no q lora), kv compressed to 512 + 64 rope dims. Full attention -> long_500k
skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("deepseek-v2-lite-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=10944,                      # dense (first) layer FFN width
        vocab_size=102400, head_dim=192,  # nope 128 + rope 64
        attn_kind="mla",
        kv_lora_rank=512, q_lora_rank=0,
        qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
        rope_theta=10000.0,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-6,
        logit_chunk=2048,
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2,
                      expert_d_ff=1408, every_k_layers=1, first_dense=1,
                      dense_d_ff=10944, capacity_factor=1.5),
    )
