"""Public moe_combine entry point: the CUDA kernel for CUDA tensors, a
shape-only launch for meta tensors (the dry run's stand-in for the card),
the plain combine (``ref.combine``) for CPU tensors, nothing else. The
mesh's combine is ``models/moe._combine_on_mesh``, not this. ``work`` is
the function's closed-form bytes."""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.moe_combine import moe_combine as K
from repro_torch.kernels.moe_combine import ref


def work(tokens: int, k: int, d: int, kept: int, elem_bytes: int
         ) -> tuple[int, int]:
    """(flops, bytes) of a combine of ``tokens`` tokens of k entries each,
    ``kept`` of them kept, rows of d elements of ``elem_bytes``: no
    product the step analysis counts (the reference counts dots); each
    kept row read once, the output written once, each entry's id and slot
    (int32) and weight read once."""
    return 0, ((kept + tokens) * d * elem_bytes
               + tokens * k * (8 + elem_bytes))


def moe_combine(eout: torch.Tensor, ids: torch.Tensor, slots: torch.Tensor,
                weights: torch.Tensor, C: int, S: int, k: int
                ) -> torch.Tensor:
    """eout [E, B*C, d], ids and slots [B*S*k] int32 as ``models/moe.
    dispatch`` returns them (a dropped entry's slot at or past C), weights
    [B*S, k] in eout's dtype -> out [B, S, d]. A step analysis counts a
    call's bytes at the most entries the shapes can keep (a meta tensor
    holds no slots)."""
    if kernels.kernel_route(eout):
        T, d = ids.shape[0] // k, eout.shape[-1]
        kept = min(T * k, eout.shape[0] * eout.shape[1])
        with kernels.entry("moe_combine", lambda: work(
                T, k, d, kept, eout.element_size())):
            return K.combine(eout, ids, slots, weights, C, S, k)
    if eout.device.type != "cpu":
        raise ValueError(f"moe_combine has no path for {eout.device}")
    return ref.combine(eout, ids, slots, weights, C, S, k)
