"""smollm-135m  [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ModelConfig, register


@register("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
        d_ff=1536, vocab_size=49152,
        rope_theta=10000.0, tie_embeddings=True,
        pad_q_heads=16, pad_kv_heads=4,   # 9H/kv3 -> 16/4 for the model axis
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-5,
    )
