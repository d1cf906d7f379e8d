"""granite-4.0-h-small  [hybrid_moe] 40L d_model=4096, vocab=100352, 32B-A9B.
[hf:ibm-granite/granite-4.0-h-small config.json]

Each layer is a pre-norm mixer, then a pre-norm MoE with a shared expert.
The mixers follow ``layer_types``: attention at layers 5, 15, 25 and 35,
Mamba-2 elsewhere (a period of 10, 9 : 1). Mamba-2: expand 2 -> d_inner
8192, 128 heads of 64, d_state 128, 1 group, conv 4 with bias, no
projection bias. Attention: GQA 32 query heads over 8 kv heads of 128, no
positional embedding (NoPE: ``rope_theta`` 0), softmax scale
``attention_multiplier`` 1/128. MoE: 72 experts, top 10 (the softmax of
the 10 largest router logits, the port's renormalised top 10), SwiGLU of
768, one shared SwiGLU of 1536. muP: embeddings x 12, each sublayer's
output x 0.22 before its residual add, logits / 16. Tied embeddings.

The published ``mamba_chunk_size`` is 256; the port's ``ssd_scan`` takes
chunks of at most 128 rows, and SSD's result does not depend on the
chunk (only its rounding does). The per-request expert capacity of 1.5
(with drops) is the port's, as deepseek-v2's.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4


@register("granite-4.0-h-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small", family="hybrid_moe",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=0, vocab_size=100352, head_dim=128,
        layer_types=PERIOD * 4,
        rope_theta=0.0,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_ngroups=1,
        ssm_conv=4, ssm_chunk=128,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-5,
        tie_embeddings=True, logit_chunk=2048,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, attention_multiplier=0.0078125,
        moe=MoEConfig(num_experts=72, top_k=10, num_shared=1,
                      expert_d_ff=768, shared_d_ff=1536,
                      capacity_factor=1.5),
    )
