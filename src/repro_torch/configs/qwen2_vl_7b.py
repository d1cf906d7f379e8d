"""qwen2-vl-7b  [vlm] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (t/h/w sections 16/24/24 over head_dim/2=64), dynamic-resolution vision
frontend is a STUB: input_specs() provides precomputed patch embeddings for a
fixed vision prefix + 3D position ids. [arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        rope_theta=1000000.0, mrope=True, mrope_sections=(16, 24, 24),
        pad_q_heads=32,                  # 28 does not divide the model axis
        vision_prefix=1024,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-6,
        logit_chunk=2048,
    )
