"""whisper-tiny  [audio] 4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.

Enc-dec; conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [B, 1500, 384]. LayerNorm + GELU.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=51865,
        encoder_layers=4, encoder_seq=1500,
        rope_theta=0.0,                 # learned absolute positions
        mlp_kind="gelu", norm_kind="ln", norm_eps=1e-5,
        pad_vocab_to=51872, logit_chunk=1024,   # 51865 does not divide 16
        scan_layers=False,              # 4 layers; unrolled
    )
