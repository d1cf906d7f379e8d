"""Plain PyTorch versions of moe_combine.

``combine`` is the one-device MoE combine as the model computes it on the
CPU (the CPU path of ``ops.moe_combine``, and the backward of the CUDA
kernel, which recomputes it): a gather of every entry's row, a select that
zeroes the dropped ones, the router weights and a sum over a token's k
entries. ``combine_in_order`` is the kernel's own arithmetic in plain
PyTorch (each product rounded to the row's type, the k terms added in f32
one by one, in order, then rounded once): the card tests hold the kernel
to it bit for bit, and to ``combine`` within one step of the last place
at the terms' scale (``term_step``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._autograd import index_select


def combine(eout: torch.Tensor, ids: torch.Tensor, slots: torch.Tensor,
            weights: torch.Tensor, C: int, S: int, k: int) -> torch.Tensor:
    """The combine on one device: entry i reads row ids[i]·C + slot of
    the expert outputs eout [E, B*C, d] seen flat (ids e·B + b), by a
    gather whose backward adds in a fixed order; a dropped entry (slot at
    or past C) reads its partition's last row and is set to zero by a
    select, not a multiply, so that no non-finite value there passes.
    -> [B, S, d]: each entry's row times its router weight (weights
    [B*S, k] in eout's dtype), a token's k entries summed in order."""
    d = eout.shape[-1]
    rows = index_select(eout.view(-1, d), 0,
                        ids.long() * C + slots.clamp(max=C - 1))
    rows = torch.where((slots < C)[:, None], rows, 0)
    return (rows * weights.reshape(-1, 1)).view(-1, S, k, d).sum(dim=2)


def _terms(eout, ids, slots, weights, C: int, S: int, k: int):
    """Each entry's product in eout's dtype, zero where dropped, as f32
    [B, S, k, d]."""
    d = eout.shape[-1]
    kept = (slots >= 0) & (slots < C)
    rows = eout.reshape(-1, d)[torch.where(kept, ids.long() * C + slots,
                                           0)]
    terms = torch.where(kept[:, None], rows * weights.reshape(-1, 1), 0)
    return terms.view(-1, S, k, d).float()


def combine_in_order(eout: torch.Tensor, ids: torch.Tensor,
                     slots: torch.Tensor, weights: torch.Tensor, C: int,
                     S: int, k: int) -> torch.Tensor:
    """``combine`` in the CUDA kernel's order: the products rounded to
    eout's dtype, then summed in f32 over j = 0 .. k-1 one term at a time
    (a dropped entry adds nothing), rounded to eout's dtype once."""
    terms = _terms(eout, ids, slots, weights, C, S, k)
    acc = torch.zeros_like(terms[:, :, 0])
    for j in range(k):
        acc = acc + terms[:, :, j]
    return acc.to(eout.dtype)


def term_step(eout: torch.Tensor, ids: torch.Tensor, slots: torch.Tensor,
              weights: torch.Tensor, C: int, S: int, k: int
              ) -> torch.Tensor:
    """One step of the last place of eout's dtype at the sum of the
    magnitudes of each output element's terms (f32 [B, S, d]; 0 where
    every term is 0): the scale at which the f32 sum rounds. Two orders
    of the sum differ by at most (k - 1) such f32 steps before the last
    rounding, so in bf16 the results lie within one such step."""
    scale = _terms(eout, ids, slots, weights, C, S, k).abs().sum(2)
    step = torch.exp2(torch.floor(torch.log2(scale))) \
        * torch.finfo(eout.dtype).eps
    return torch.where(scale > 0, step, 0)
