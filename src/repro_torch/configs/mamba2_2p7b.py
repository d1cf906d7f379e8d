"""mamba2-2.7b  [ssm] 64L d_model=2560, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality), expand=2 -> d_inner 5120, head_dim 64 -> 80 heads,
1 group, conv width 4, chunk 256. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        attn_kind="none",
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_ngroups=1,
        ssm_conv=4, ssm_chunk=128,
        norm_kind="rms", norm_eps=1e-5, tie_embeddings=True,
        pad_vocab_to=50288, logit_chunk=2048,   # 50280 does not divide 16
    )
