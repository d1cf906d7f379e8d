"""Public partition_pack entry points: the CUDA kernel for CUDA tensors,
the plain PyTorch version (``ref``) for CPU tensors, nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels.partition_pack import partition_pack as K
from repro_torch.kernels.partition_pack import ref


def partition_pack_groups(groups: list[torch.Tensor], part_ids: torch.Tensor,
                          *, n_parts: int, capacity: int):
    """Row groups [T, d_g] packed by one slot computation over part_ids [T]
    -> ([buf_g [n_parts, capacity, d_g]], counts [n_parts], slots [T]).

    Entries past a partition's capacity are dropped (bounded buffers); the
    counts vector is the §3.2 offsets header (offsets = cumsum(counts))."""
    if part_ids.device.type == "cuda":
        return K.pack(groups, part_ids, n_parts, capacity)
    if part_ids.device.type != "cpu":
        raise ValueError(f"partition_pack has no path for {part_ids.device}")
    return K.plain_pack(groups, part_ids, n_parts, capacity)


def partition_pack(rows: torch.Tensor, part_ids: torch.Tensor, *,
                   n_parts: int, capacity: int):
    """rows [T, d], part_ids [T] -> (buf [n_parts, capacity, d], counts,
    slots) — the signature of the Pallas ``pack_pallas``."""
    (buf,), counts, slots = partition_pack_groups(
        [rows], part_ids, n_parts=n_parts, capacity=capacity)
    return buf, counts, slots


def partition_unpack(buf, part_ids, slots, capacity: int):
    keep = slots < capacity
    return ref.unpack(buf, part_ids, slots, keep)
