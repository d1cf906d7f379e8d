"""llama4-maverick-400b-a17b  [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1, shared expert, MoE every 2nd layer.

iRoPE-style interleaved attention: chunked-local (8192) with every 4th layer
global. 400B total / ~17B active. [hf:meta-llama/Llama-4-*; unverified tier]

This is the arch most representative of the paper's technique: the token ->
expert dispatch is a partitioned shuffle (C2) and crosses pods via the
multi-stage hierarchical all-to-all (C3).
"""
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=16384,                       # dense-layer FFN width
        vocab_size=202048,
        rope_theta=500000.0,
        pad_q_heads=48,              # 40 -> 48 (divides 16-way model axis)
        chunked_local=8192, global_every=4,
        mlp_kind="swiglu", norm_kind="rms", norm_eps=1e-5,
        moe=MoEConfig(num_experts=128, top_k=1, num_shared=1,
                      expert_d_ff=8192, every_k_layers=2, dense_d_ff=16384,
                      capacity_factor=1.25),
        # 400B params: bf16 params + Adafactor so train_4k fits 256 chips
        param_dtype=torch.bfloat16, optimizer="adafactor", logit_chunk=2048,
        grad_accum=4,                     # 400B on 256 v5e: microbatch 64
        scan_layers=True,                 # scan over 4-layer super-blocks
        moe_impl="a2a",                   # token-moving EP (see §Perf): flat
                                          # a2a beats FSDP-gathered experts
                                          # AND pod-replicated hierarchical
    )
