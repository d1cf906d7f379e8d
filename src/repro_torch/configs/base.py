"""Architecture + shape configuration.

One ``ModelConfig`` describes any of the assigned architectures; per-arch
modules in this package instantiate it with the published numbers. Shapes are
the four assigned input-shape cells. ``registry()`` maps --arch ids to
configs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Serverless I/O reference constants (Starling reproduction, Fig 3):
# the NIC-level aggregate read-throughput cap a single invocation
# saturates near ~16 parallel lanes. The canonical values (and every
# in-repo consumer) live in objectstore.latency — re-exposed here for
# visibility next to the shape/arch knobs; to retune the simulation,
# override repro_torch.objectstore.latency.NIC_AGG_READ_BPS (read at call
# time by lane_throughput_Bps), not these aliases.
from repro_torch.objectstore.latency import (  # noqa: F401
    NIC_AGG_READ_BPS, NIC_SATURATION_LANES)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 1
    num_shared: int = 0             # shared (always-on) experts
    expert_d_ff: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    every_k_layers: int = 1         # MoE layer every k-th layer (llama4: 2)
    first_dense: int = 0            # leading dense layers (deepseek: 1)
    dense_d_ff: int = 0             # d_ff used by the dense layers in MoE nets
    router_impl: str = "topk"       # topk | sinkhorn (future)
    shared_d_ff: int = 0            # the shared experts' width; 0 ->
                                    # num_shared * expert_d_ff
    # the chip's expert share: the experts first_held .. first_held +
    # held_experts - 1 of the num_experts routed over live here (their
    # weights, their part of each layer's result); 0 -> all of them
    held_experts: int = 0
    first_held: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | hybrid_moe
                                    # | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention flavor ---
    attn_kind: str = "gqa"          # gqa | mla | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # glm4 uses partial rotary (0.5)
    mrope: bool = False             # qwen2-vl multimodal rope (t/h/w sections)
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    window: int = 0                 # sliding-window size; 0 = full
    # llama4-style interleave: every k-th layer is global, others chunked-local
    chunked_local: int = 0          # chunk size; 0 = disabled
    global_every: int = 4
    # TPU head padding: pad q/kv head counts so they divide the model axis;
    # dummy-head outputs are masked to zero before wo, so the function (and
    # all gradients to real parameters) is exactly the unpadded model's.
    pad_q_heads: int = 0            # 0 = no padding
    pad_kv_heads: int = 0
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- mlp ---
    mlp_kind: str = "swiglu"        # swiglu | gelu
    norm_kind: str = "rms"          # rms | ln
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec","rec","attn")
    lru_width: int = 0
    # --- hybrid_moe (granite-4.0-h): each layer's mixer, "mamba" or
    # "attention", as published; a cut in depth keeps the first num_layers
    layer_types: tuple[str, ...] = ()
    # --- muP multipliers (granite-4.0-h); at their defaults nothing runs
    embedding_multiplier: float = 1.0   # the embedding's output x this
    residual_multiplier: float = 1.0    # each sublayer's output x this
                                        # before its residual add
    logits_scaling: float = 1.0         # the logits / this
    attention_multiplier: float = 0.0   # softmax scale; 0 -> 1/sqrt(head_dim)
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500         # precomputed frame embeddings (stub frontend)
    # --- vlm (qwen2-vl) ---
    vision_prefix: int = 0          # precomputed patch embeddings (stub frontend)
    # --- dtypes / training ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    optimizer: str = "adamw"        # adamw | adafactor
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: str = "full"             # full | dots | none
    attn_impl: str = "block_tri"    # block_tri=causal-split (default; see §Perf) | chunked
    attn_chunk: int = 512
    moe_impl: str = "gspmd"         # gspmd | a2a | hierarchical
    # kept so the two packages' configs have the same fields; the port's
    # model code never reads it: on CUDA tensors the hand-written kernels
    # always run, on CPU tensors their plain PyTorch versions
    use_pallas: bool = False
    logit_chunk: int = 0            # chunked loss over seq; 0 = off
    grad_accum: int = 1             # microbatches per step (grad accumulation)
    pad_vocab_to: int = 0           # pad vocab so it divides the model axis
                                    # (padded logits masked to -inf: exact)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic path exists)
LONG_CONTEXT_OK = {"mamba2-2.7b", "recurrentgemma-9b", "llama4-maverick-400b-a17b"}


def cells(arch_id: str) -> list[str]:
    """The shape cells that run for an arch (skip rules per DESIGN.md §7)."""
    out = []
    for s in SHAPES:
        if s == "long_500k" and arch_id not in LONG_CONTEXT_OK:
            continue
        out.append(s)
    return out


_REGISTRY: dict[str, Any] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def registry() -> dict[str, Any]:
    # import side-effect registration
    from repro_torch.configs import deepseek_v2_lite  # noqa: F401
    from repro_torch.configs import glm4_9b  # noqa: F401
    from repro_torch.configs import granite4_h_small  # noqa: F401
    from repro_torch.configs import granite_20b  # noqa: F401
    from repro_torch.configs import llama4_maverick_400b  # noqa: F401
    from repro_torch.configs import mamba2_2p7b  # noqa: F401
    from repro_torch.configs import qwen2_vl_7b  # noqa: F401
    from repro_torch.configs import recurrentgemma_9b  # noqa: F401
    from repro_torch.configs import smollm_135m  # noqa: F401
    from repro_torch.configs import starcoder2_3b  # noqa: F401
    from repro_torch.configs import whisper_tiny  # noqa: F401
    return dict(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    reg = registry()
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(reg)}")
    return reg[arch_id]()
