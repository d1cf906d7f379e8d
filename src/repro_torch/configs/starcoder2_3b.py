"""starcoder2-3b  [dense] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA, RoPE; LayerNorm + GELU MLP per the published config. Sliding window 4096
exists in the published model; we keep full attention (long_500k is skipped
for this arch anyway) and note it in DESIGN.md. [arXiv:2402.19173]
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        d_ff=12288, vocab_size=49152,
        rope_theta=999999.4420358813,
        mlp_kind="gelu", norm_kind="ln", norm_eps=1e-5,
        logit_chunk=2048,
    )
