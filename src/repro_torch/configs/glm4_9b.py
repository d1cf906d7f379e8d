"""glm4-9b  [dense] 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

RoPE (partial rotary 0.5), GQA. [hf:THUDM/glm-4-9b]
"""
from repro_torch.configs.base import ModelConfig, register


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=151552,
        rope_theta=10000.0, rope_fraction=0.5,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-5,
        logit_chunk=2048,
    )
