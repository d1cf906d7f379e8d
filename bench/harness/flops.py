"""The benchmark's frozen arithmetic: the model FLOPs of a prefill, the
work of the two kernels at a call's shapes, and the peaks of one H100
(SXM, NVIDIA's data sheet, dense, at 700 W). A model's structure comes
from its reference (``bench/reference/<family>.py: structure``), read from
the configuration file, never from the program."""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask leaves in a sequence of S."""
    return S * (S + 1) // 2


def attention_flops(att: dict, B: int, S: int) -> int:
    """q.k (2 d_qk) and p.v (2 d_v) a pair, a head, a layer."""
    return (2 * att["heads"] * (att["d_qk"] + att["d_v"]) * causal_pairs(S)
            * B * att["layers"])


def model_flops(st: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill of B prompts of S tokens: 2 x the active
    non-embedding matrix parameters (routed experts at top-k, not at
    capacity) a token, causal attention, and the head once a sequence
    (the prefill returns the last position's logits only)."""
    return (2 * st["matmul_params"] * B * S
            + sum(attention_flops(a, B, S) for a in st["attention"])
            + 2 * st["head_params"] * B)


def flash_work(att: dict, B: int, S: int) -> tuple[int, int]:
    """(flops, bytes) of one causal attention call of one layer: the pairs
    the mask leaves; q, k, v read once and o written once, in bf16."""
    H, Hkv, D, Dv = att["heads"], att["kv_heads"], att["d_qk"], att["d_v"]
    flops = 2 * H * (D + Dv) * causal_pairs(S) * B
    nbytes = (B * S * H * (D + Dv) + B * S * Hkv * (D + Dv)) * BF16
    return flops, nbytes


def expert_capacity(S: int, moe: dict) -> int:
    """Slots an expert has in one request of S tokens."""
    c = math.ceil(S * moe["top_k"] / moe["experts"] * moe["capacity_factor"])
    a = moe["align"]
    return max(a, (c + a - 1) // a * a)


def pack_bytes(T: int, row_bytes: int, n_parts: int, capacity: int) -> int:
    """Bytes of one pack of T entries into n_parts x capacity slots: ids
    and rows read once; slots, counts and the buffer written once."""
    return (4 * T + T * row_bytes + 4 * T + 4 * n_parts
            + n_parts * capacity * row_bytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
