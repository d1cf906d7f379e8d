"""Plain PyTorch oracle of flash_gqa: materialized attention (port of
``repro.kernels.flash_gqa.ref``). It is the CPU path of ``ops.flash_gqa``
and what the CUDA kernel is held against on the card."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q [B,Sq,H,D], k [B,Skv,H,D], v [B,Skv,H,Dv]; full score
    materialization (oracle) -> [B,Sq,H,Dv].
    When Skv > Sq the queries are aligned to the END of kv (query i sits at
    kv position i + Skv - Sq), as in the reference. ``scale``: the softmax
    scale (None: 1/sqrt(D))."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(D) if scale is None else s * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos + (Skv - Sq)        # q offset when Skv > Sq
    if window > 0:
        m &= kpos > qpos + (Skv - Sq) - window
    s = s.masked_fill(~m[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
