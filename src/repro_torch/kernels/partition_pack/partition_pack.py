"""CUDA wrapper of the Hopper partition_pack kernel
(``csrc/partition_pack.cu``, which replaces the Pallas ``pack_pallas`` of
src/repro/kernels/partition_pack/partition_pack.py; the source's note
gives the design and its memory bound).

One ``pack`` call runs the count/slot passes once over ``part_ids`` and
then one gather per row group, so a table's 8-byte and 4-byte column
groups share a single slot computation. The wrapper allocates every
output, launches on the current stream, checks the error code after each
launch, and counts one launch per call in ``launches``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

launches = 0                      # pack() calls that launched the kernels
_count_lock = threading.Lock()
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("partition_pack")
    lib.pp_count_slots.argtypes = [_P, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P, _P, _P]
    lib.pp_count_slots.restype = ctypes.c_int
    lib.pp_gather.argtypes = [_P, _P, _P, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int, _P]
    lib.pp_gather.restype = ctypes.c_int
    lib.pp_error_string.argtypes = [ctypes.c_int]
    lib.pp_error_string.restype = ctypes.c_char_p
    lib.pp_max_parts.restype = ctypes.c_int
    lib.pp_tile_rows.restype = ctypes.c_int
    return lib


def _check(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.pp_error_string(err).decode()}")


def pack(groups: list[torch.Tensor], part_ids: torch.Tensor, n_parts: int,
         capacity: int):
    """groups: row blocks [T, d_g] (elements of 2, 4 or 8 bytes) on one CUDA
    device; part_ids [T] int32 in [0, n_parts).
    -> ([buf_g [n_parts, capacity, d_g]], counts [n_parts] int32,
        slots [T] int32)."""
    global launches
    dev = part_ids.device
    if dev.type != "cuda":
        raise ValueError(f"partition_pack kernel needs CUDA tensors, got "
                         f"{dev}")
    if part_ids.dtype != torch.int32 or part_ids.dim() != 1 \
            or not part_ids.is_contiguous():
        raise ValueError("part_ids must be a contiguous 1-D int32 tensor")
    T = part_ids.shape[0]
    if T >= 2 ** 31:
        raise ValueError(f"{T} rows: the kernel indexes rows in int32")
    for g in groups:
        if g.device != dev or g.dim() != 2 or g.shape[0] != T \
                or not g.is_contiguous() or g.element_size() not in (2, 4, 8):
            raise ValueError(
                f"each group must be a contiguous [{T}, d] tensor on {dev} "
                f"of 2-, 4- or 8-byte elements; got {tuple(g.shape)} "
                f"{g.dtype} on {g.device}")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    lib = _lib()
    if not 1 <= n_parts <= lib.pp_max_parts():
        raise ValueError(f"n_parts {n_parts} outside [1, "
                         f"{lib.pp_max_parts()}]: the per-tile running "
                         "counts live in shared memory")
    counts = torch.zeros(n_parts, dtype=torch.int32, device=dev)
    slots = torch.empty(T, dtype=torch.int32, device=dev)
    if T == 0:
        return ([torch.zeros((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                             device=dev) for g in groups], counts, slots)
    bufs = [torch.empty((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                        device=dev) for g in groups]
    row_of = torch.full((n_parts, capacity), -1, dtype=torch.int32,
                        device=dev)
    n_tiles = -(-T // lib.pp_tile_rows())
    tile_counts = torch.empty(n_parts * n_tiles, dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.pp_count_slots(
            part_ids.data_ptr(), T, n_parts, capacity,
            tile_counts.data_ptr(), counts.data_ptr(), slots.data_ptr(),
            row_of.data_ptr(), stream), "pp_count_slots")
        for g, buf in zip(groups, bufs):
            if buf.numel():
                _check(lib, lib.pp_gather(
                    g.data_ptr(), row_of.data_ptr(), buf.data_ptr(),
                    n_parts * capacity, g.shape[1], g.element_size(),
                    stream), "pp_gather")
    with _count_lock:
        launches += 1
    return bufs, counts, slots
