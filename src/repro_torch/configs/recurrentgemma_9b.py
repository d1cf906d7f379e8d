"""recurrentgemma-9b  [hybrid] 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. RG-LRU + local attention (window 2048), pattern rec,rec,attn.

38 = 12 x (rec,rec,attn) + (rec,rec): we scan 12 triple-blocks and unroll the
trailing two recurrent layers. [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        window=2048, rope_theta=10000.0,
        block_pattern=("rec", "rec", "attn"),
        lru_width=4096,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-6,
        logit_chunk=2048, grad_accum=2,
    )
