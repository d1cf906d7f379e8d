"""Reduced same-family configs for CPU smoke tests.

Same structure as the full arch (family, attention kind, MoE topology,
block pattern), shrunk to run one forward/train step on one CPU device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, get_config


def smoke_config(arch_id: str) -> ModelConfig:
    cfg = get_config(arch_id)
    kw: dict = dict(
        d_model=64, vocab_size=512, param_dtype=torch.float32,
        compute_dtype=torch.float32, attn_chunk=8, logit_chunk=0,
        remat="full",
    )
    if cfg.family == "ssm":
        kw.update(num_layers=4, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    elif cfg.family == "hybrid":
        kw.update(num_layers=5, num_heads=4, num_kv_heads=1, head_dim=16,
                  d_ff=96, lru_width=64, window=8)
    elif cfg.name.startswith("llama4"):
        kw.update(num_layers=4, num_heads=4, num_kv_heads=2, d_ff=96,
                  chunked_local=8,
                  moe=dataclasses.replace(cfg.moe, num_experts=4, top_k=1,
                                          expert_d_ff=48, dense_d_ff=96))
    elif cfg.attn_kind == "mla":
        kw.update(num_layers=3, num_heads=4, num_kv_heads=4, head_dim=24,
                  kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
                  v_head_dim=16, d_ff=96,
                  moe=dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                          num_shared=1, expert_d_ff=32,
                                          dense_d_ff=96))
    elif cfg.family == "audio":
        kw.update(num_layers=2, encoder_layers=2, num_heads=4, num_kv_heads=4,
                  d_ff=96, encoder_seq=12)
    else:
        kw.update(num_layers=3, d_ff=96,
                  num_heads=cfg.num_heads if cfg.num_heads <= 9 else 4,
                  num_kv_heads=min(cfg.num_kv_heads, 3))
        if cfg.num_heads > 9:
            kw["num_kv_heads"] = 2
        if cfg.mrope:
            kw.update(num_heads=4, num_kv_heads=2, head_dim=16,
                      mrope_sections=(2, 3, 3), vision_prefix=4)
    if cfg.family not in ("ssm",) and "head_dim" not in kw:
        kw.setdefault("head_dim", 16)
    return cfg.replace(**kw)
