"""Public partition_pack entry points: the CUDA kernel for CUDA tensors, a
shape-only launch for meta tensors (the dry run's stand-in for the card),
the plain PyTorch version (``ref``) for CPU tensors, nothing else.
DTensors (a mesh's dry run) are gathered whole and packed on every device
(``_on_mesh``). ``work`` is the function's closed-form bytes."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import kernels
from repro_torch.kernels.partition_pack import partition_pack as K
from repro_torch.kernels.partition_pack import ref


def work(T: int, row_bytes: int, n_parts: int, capacity: int
         ) -> tuple[int, int]:
    """(flops, bytes) of a pack of T rows of ``row_bytes`` (all groups)
    into n_parts x capacity slots: no arithmetic; ids and rows read once,
    slots, counts and buf written once."""
    return 0, (4 * T + T * row_bytes + 4 * T + 4 * n_parts
               + n_parts * capacity * row_bytes)


def partition_pack_groups(groups: list[torch.Tensor], part_ids: torch.Tensor,
                          *, n_parts: int, capacity: int):
    """Row groups [T, d_g] packed by one slot computation over part_ids [T]
    -> ([buf_g [n_parts, capacity, d_g]], counts [n_parts], slots [T]).

    Entries past a partition's capacity are dropped (bounded buffers); the
    counts vector is the §3.2 offsets header (offsets = cumsum(counts))."""
    if isinstance(part_ids, DTensor):
        return _on_mesh(groups, part_ids, n_parts, capacity)
    if kernels.kernel_route(part_ids):
        row_bytes = sum(g.shape[1] * g.element_size() for g in groups)
        with kernels.entry("partition_pack", lambda: work(
                part_ids.shape[0], row_bytes, n_parts, capacity)):
            return K.pack(groups, part_ids, n_parts, capacity)
    if part_ids.device.type != "cpu":
        raise ValueError(f"partition_pack has no path for {part_ids.device}")
    return K.plain_pack(groups, part_ids, n_parts, capacity)


def _on_mesh(groups, part_ids, n_parts: int, capacity: int):
    """The call on DTensors: the ids and rows are gathered whole (a slot
    depends on every earlier row of its partition) and every device packs
    them all; the outputs are replicated."""
    mesh = part_ids.device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [t.redistribute(mesh, rep).to_local()
             if isinstance(t, DTensor) else t for t in (*groups, part_ids)]
    bufs, counts, slots = partition_pack_groups(
        local[:-1], local[-1], n_parts=n_parts, capacity=capacity)
    return ([kernels.from_local(b, mesh, rep, b.shape) for b in bufs],
            kernels.from_local(counts, mesh, rep, counts.shape),
            kernels.from_local(slots, mesh, rep, slots.shape))


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
