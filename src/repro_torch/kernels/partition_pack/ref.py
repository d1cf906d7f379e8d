"""Plain PyTorch version of partition_pack.

The Starling §3.2 partitioned-object layout as a tensor op: given rows and
their destination partition ids, produce
  * a partition-major packed buffer [n_parts, capacity, d] (rows past a
    partition's capacity are dropped — bounded buffers),
  * the per-partition counts ("offsets header"),
  * the (row -> (partition, slot)) mapping used by unpack/combine.

It is the hash-partition of relational/ops.py in one primitive. The CPU
path of ``ops.partition_pack`` runs it, and the tests and chip_smoke.py
hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def pack_indices(part_ids: torch.Tensor, n_parts: int, capacity: int):
    """part_ids [T] int32 -> (slot [T], counts [n_parts], keep [T]).

    slot is the position within the destination partition (stable order);
    entries past `capacity` are dropped (keep=False).
    """
    T = part_ids.shape[0]
    ids = part_ids.long()
    sort_idx = torch.sort(ids, stable=True).indices
    sorted_p = ids[sort_idx]
    counts = torch.bincount(ids, minlength=n_parts)[:n_parts]
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_p = torch.arange(T, device=ids.device) - offsets[sorted_p]
    slot = torch.empty(T, dtype=torch.int32, device=ids.device)
    slot[sort_idx] = pos_in_p.to(torch.int32)
    keep = slot < capacity
    return slot, counts.to(torch.int32), keep


def pack_rows(rows: torch.Tensor, part_ids: torch.Tensor,
              slot: torch.Tensor, keep: torch.Tensor, n_parts: int,
              capacity: int) -> torch.Tensor:
    """rows [T, d] -> buf [n_parts, capacity, d] at the given slots."""
    d = rows.shape[1]
    buf = torch.zeros((n_parts, capacity + 1, d), dtype=rows.dtype,
                      device=rows.device)
    s_idx = torch.where(keep, slot, capacity).long()       # overflow slot
    buf[part_ids.long(), s_idx] = rows
    return buf[:, :capacity]


def pack(rows: torch.Tensor, part_ids: torch.Tensor, n_parts: int,
         capacity: int):
    """rows [T, d] -> (buf [n_parts, capacity, d], counts, slot, keep)."""
    slot, counts, keep = pack_indices(part_ids, n_parts, capacity)
    buf = pack_rows(rows, part_ids, slot, keep, n_parts, capacity)
    return buf, counts, slot, keep


def unpack(buf: torch.Tensor, part_ids: torch.Tensor, slot: torch.Tensor,
           keep: torch.Tensor) -> torch.Tensor:
    """Inverse range-read: row i <- buf[part_ids[i], slot[i]] (0 if
    dropped)."""
    padded = torch.nn.functional.pad(buf, (0, 0, 0, 1))
    s_idx = torch.where(keep, slot, buf.shape[1]).long()
    out = padded[part_ids.long(), s_idx]
    return out * keep[:, None].to(out.dtype)
