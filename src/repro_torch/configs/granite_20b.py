"""granite-20b  [dense] 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch, code model. [arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        rope_theta=10000.0,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-5,
        logit_chunk=2048, grad_accum=2,
    )
