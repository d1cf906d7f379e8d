"""Public flash_gqa entry point in model layout: the CUDA kernel for CUDA
tensors, the plain materialized attention for CPU tensors, nothing else.
Both take the same arguments and refuse the same ones (``ValueError``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_gqa import flash_gqa as K
from repro_torch.kernels.flash_gqa.ref import attention_ref


def flash_gqa(q, k, v, *, causal: bool = True, window: int = 0,
              kv_head=None):
    """q [B,S,H,D]; k/v [B,S,Hkv,D]; ``kv_head`` maps query head h to its kv
    head (host ints; default h // (H / Hkv)). -> o [B,S,H,D] in q's
    dtype."""
    if q.device.type == "cuda":
        return K.flash_gqa(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, kv_head=kv_head)
    if q.device.type != "cpu":
        raise ValueError(f"flash_gqa has no path for {q.device}")
    m = torch.tensor(K.check_args(q, k, v, window, kv_head))
    return attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
