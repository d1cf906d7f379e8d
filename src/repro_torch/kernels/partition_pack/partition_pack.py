"""CUDA wrapper of the Hopper partition_pack kernel
(``csrc/partition_pack.cu``, which replaces the Pallas ``pack_pallas`` of
src/repro/kernels/partition_pack/partition_pack.py; the source's note
gives the design, its launches and its memory bound).

``pack`` packs row groups by given partition ids: up to
``LOOKBACK_MAX_PARTS`` partitions one pass with decoupled look-back
computes the slots and places every group's rows, and a second launch
zero-fills the partitions' tails; above, three launches (tile histograms,
their scan, the placement). ``pack_by_key`` is the shuffle producer's
entry: one launch hashes an int64 key column into partition ids, the
tiles' histograms (the pack's look-back aggregates) and the counts; the
wrapper reads the counts to the host (the call's only sync) to size the
buffers at capacity = the largest count, and one launch packs, tails
included (above ``LOOKBACK_MAX_PARTS``, a scan launch before it).

The wrapper allocates every output with ``torch.empty``, launches on the
current stream, checks the error code after each launch, and counts one
launch per call in ``launches``. The look-back's ticket counters and
status words live in a ``Workspace`` per (device, stream), which the
module lock serializes. Where grad is needed (a float row group that
requires it) a call runs inside an autograd Function whose backward is the
plain version's (``kernels/_autograd.py``): the float row groups get the
gradient, the ids, counts and slots none. On the meta device (the dry run)
a ``pack`` call is shape-only: it allocates the outputs and computes
nothing.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels.partition_pack import ref

launches = 0                      # pack() / pack_by_key() calls launched
MAX_PARTS = 8192                  # PP_MAX_PARTS
LOOKBACK_MAX_PARTS = 64           # the look-back route up to here (at
                                  # most PP_LOOKBACK_MAX_PARTS), then
                                  # multi-pass
TILE_ROWS = 2048                  # PP_TILE
MAX_GROUPS = 8                    # PP_MAX_GROUPS
PHASES = ("start", "tile", "ranked", "prefix", "slots", "rows", "end")
PHASE_CLOCKS = len(PHASES)        # PP_CLOCKS: pp_place's clocks a tile
EPOCH_LIMIT = 1 << 31             # status words keep 31 bits of epoch
_lock = threading.Lock()
_workspaces: dict[tuple, "Workspace"] = {}
_loaded: ctypes.CDLL | None = None
_P = ctypes.c_void_p


class Workspace:
    """What the look-back keeps between calls on one stream: two ticket
    counters (uint64 on the device: pp_place's tiles, pp_hash_count's
    blocks) with the host's count of tickets issued so far, the status
    words (a tile's value, flag and epoch per partition) with the call's
    epoch, and pp_hash_count's zeroed accumulator. Nothing here is reset
    per call: a call's tickets start where the last call's ended, and
    status words of an earlier epoch read as unpublished. The status words
    are zero-filled only when they grow (or, once in 2^31 calls, when the
    epoch wraps)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.tickets = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.issued = [0, 0]
        self.status = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.acc = torch.zeros(MAX_PARTS, dtype=torch.int32,
                               device=self.device)
        self.epoch = 0

    def place(self, n_tiles: int, n_parts: int) -> tuple[int, int]:
        """-> (ticket base, epoch) of the next pp_place launch, with room
        for its n_tiles x n_parts status words."""
        need = n_tiles * n_parts
        if self.status.numel() < need:
            self.status = torch.zeros(max(need, 2 * self.status.numel()),
                                      dtype=torch.int64, device=self.device)
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:
            self.status.zero_()
            self.epoch = 1
        base = self.issued[0]
        self.issued[0] += n_tiles
        return base, self.epoch

    def hash(self, n_blocks: int) -> int:
        """-> the ticket base of the next pp_hash_count launch."""
        base = self.issued[1]
        self.issued[1] += n_blocks
        return base

    def ticket(self, which: int) -> int:
        return self.tickets.data_ptr() + 8 * which


def _workspace(dev: torch.device, stream: int) -> Workspace:
    ws = _workspaces.get((dev.index, stream))
    if ws is None:
        ws = _workspaces[(dev.index, stream)] = Workspace(dev)
    return ws


def _lib() -> ctypes.CDLL:
    """The built library with its signatures, loaded once."""
    global _loaded
    if _loaded is None:
        _loaded = _bind(_build.load("partition_pack"))
    return _loaded


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pp_pack.argtypes = [
        _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,          # ids .. cap
        ctypes.c_int, _P, _P, _P,                                # groups
        _P, _P, _P,                                              # counts ..
        _P, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32,      # look-back
        _P, _P, ctypes.c_int, _P,
        _P]                                                      # stream
    lib.pp_pack.restype = ctypes.c_int
    lib.pp_hash_count.argtypes = [_P, ctypes.c_int64, ctypes.c_int, _P, _P,
                                  _P, _P, ctypes.c_uint64, _P,
                                  ctypes.c_uint32, _P, _P]
    lib.pp_hash_count.restype = ctypes.c_int
    lib.pp_hash_blocks.argtypes = [ctypes.c_int64]
    lib.pp_hash_blocks.restype = ctypes.c_int
    lib.pp_error_string.argtypes = [ctypes.c_int]
    lib.pp_error_string.restype = ctypes.c_char_p
    for name, want in (("pp_max_parts", MAX_PARTS),
                       ("pp_tile_rows", TILE_ROWS),
                       ("pp_max_groups", MAX_GROUPS)):
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(f"{name}() is {got}, the wrapper has {want}")
    if LOOKBACK_MAX_PARTS > lib.pp_lookback_max_parts():
        raise RuntimeError(f"the look-back route takes at most "
                           f"{lib.pp_lookback_max_parts()} partitions")
    return lib


def _check(lib, err: int, what: str, dev: torch.device, stream: int):
    if err:
        # a launch that did not run took none of the tickets the workspace
        # counted: start the stream's next call on a fresh workspace
        _workspaces.pop((dev.index, stream), None)
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.pp_error_string(err).decode()}")


def _check_groups(groups: list[torch.Tensor], T: int, dev: torch.device):
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"{len(groups)} row groups; at most {MAX_GROUPS}")
    for g in groups:
        if g.device != dev or g.dim() != 2 or g.shape[0] != T \
                or not g.is_contiguous() or g.element_size() not in (2, 4, 8):
            raise ValueError(
                f"each group must be a contiguous [{T}, d] tensor on {dev} "
                f"of 2-, 4- or 8-byte elements; got {tuple(g.shape)} "
                f"{g.dtype} on {g.device}")


def _check_parts(n_parts: int):
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"n_parts {n_parts} outside [1, {MAX_PARTS}]: the "
                         "per-tile counts live in shared memory")


def _cuda(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"partition_pack kernel needs CUDA tensors, got "
                         f"{dev}")


def _group_args(groups, bufs):
    n = len(groups)
    srcs = (ctypes.c_void_p * max(n, 1))(*[g.data_ptr() for g in groups])
    dsts = (ctypes.c_void_p * max(n, 1))(*[b.data_ptr() for b in bufs])
    rows = (ctypes.c_int64 * max(n, 1))(
        *[g.shape[1] * g.element_size() for g in groups])
    return n, srcs, dsts, rows


def _route(ws: Workspace, T: int, n_parts: int, dev: torch.device):
    """-> (look-back?, ticket base, epoch, multi-pass scratch) of the next
    pack of T rows (the caller holds ``_lock``)."""
    n_tiles = -(-T // TILE_ROWS)
    if n_parts <= LOOKBACK_MAX_PARTS:
        return (True, *ws.place(n_tiles, n_parts), None)
    return False, 0, 0, torch.empty(n_parts * (n_tiles + 1),
                                     dtype=torch.int32, device=dev)


def _launch_pack(lib, groups, bufs, ids, n_parts, capacity, known, counts,
                 slots, dev, stream, ws, route, published=False,
                 clocks=None):
    """pp_pack on ``stream`` (the caller holds ``_lock``)."""
    lookback, base, epoch, scratch = route
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _check(lib, lib.pp_pack(
        ids.data_ptr(), ids.shape[0], n_parts, capacity,
        *_group_args(groups, bufs), ptr(known), ptr(counts), ptr(slots),
        ws.ticket(0), base, int(lookback), epoch, ws.status.data_ptr(),
        ptr(scratch), int(published), ptr(clocks), stream), "pp_pack", dev,
        stream)


def plain_pack(groups: list[torch.Tensor], part_ids: torch.Tensor,
               n_parts: int, capacity: int):
    """``pack``'s plain version on any device (``ref``), with the kernel's
    slot -1 for ids outside [0, n_parts).
    -> ([buf_g], counts [n_parts] int32, slots [T] int32)."""
    ids = part_ids.long()
    valid = (ids >= 0) & (ids < n_parts)
    sel = torch.nonzero(valid).flatten()
    vids = part_ids[sel]
    slot, counts, keep = ref.pack_indices(vids, n_parts, capacity)
    bufs = [ref.pack_rows(g[sel], vids, slot, keep, n_parts, capacity)
            for g in groups]
    slots = torch.full_like(part_ids, -1).index_put_((sel,), slot)
    return bufs, counts, slots


def pack(groups: list[torch.Tensor], part_ids: torch.Tensor, n_parts: int,
         capacity: int, clocks: torch.Tensor | None = None):
    """groups: row blocks [T, d_g] (elements of 2, 4 or 8 bytes) on one CUDA
    device; part_ids [T] int32 (rows with an id outside [0, n_parts) get
    slot -1 and are not packed). clocks, a measurement aid: an int64
    [ceil(T / TILE_ROWS), PHASE_CLOCKS] tensor on the device that receives
    each tile's phase clocks (``PHASES``, ns on the device's clock).
    -> ([buf_g [n_parts, capacity, d_g]], counts [n_parts] int32,
        slots [T] int32). The float groups' buffers are differentiable
    through ``plain_pack``."""
    n = len(groups)

    def launch(*t):
        if part_ids.device.type == "meta":
            bufs, counts, slots = _shape_only(list(t[:n]), t[n], n_parts,
                                              capacity)
        else:
            bufs, counts, slots = _launch_pack_call(list(t[:n]), t[n],
                                                    n_parts, capacity, clocks)
        return (*bufs, counts, slots)

    def plain(*t):
        bufs, counts, slots = plain_pack(list(t[:n]), t[n], n_parts,
                                         capacity)
        return (*bufs, counts, slots)

    *bufs, counts, slots = kernel_call(launch, plain, *groups, part_ids)
    return bufs, counts, slots


def _shape_only(groups: list[torch.Tensor], part_ids: torch.Tensor,
                n_parts: int, capacity: int):
    """A ``pack`` call on the meta device (the dry run): the outputs a
    launch allocates, nothing computed and nothing counted."""
    dev = part_ids.device
    return ([torch.empty((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                         device=dev) for g in groups],
            torch.empty(n_parts, dtype=torch.int32, device=dev),
            torch.empty(part_ids.shape[0], dtype=torch.int32, device=dev))


def _launch_pack_call(groups: list[torch.Tensor], part_ids: torch.Tensor,
                      n_parts: int, capacity: int,
                      clocks: torch.Tensor | None):
    """One ``pack`` call of the kernels, without autograd."""
    global launches
    dev = part_ids.device
    _cuda(dev)
    if part_ids.dtype != torch.int32 or part_ids.dim() != 1 \
            or not part_ids.is_contiguous():
        raise ValueError("part_ids must be a contiguous 1-D int32 tensor")
    T = part_ids.shape[0]
    if T >= 2 ** 31:
        raise ValueError(f"{T} rows: the kernel indexes rows in int32")
    _check_groups(groups, T, dev)
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")
    _check_parts(n_parts)
    if T == 0:
        return ([torch.zeros((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                             device=dev) for g in groups],
                torch.zeros(n_parts, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    lib = _lib()
    counts = torch.empty(n_parts, dtype=torch.int32, device=dev)
    slots = torch.empty(T, dtype=torch.int32, device=dev)
    bufs = [torch.empty((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                        device=dev) for g in groups]
    if clocks is not None and (
            clocks.device != dev or clocks.dtype != torch.int64
            or tuple(clocks.shape) != (-(-T // TILE_ROWS), PHASE_CLOCKS)
            or not clocks.is_contiguous()):
        raise ValueError(f"clocks must be a contiguous int64 "
                         f"[{-(-T // TILE_ROWS)}, {PHASE_CLOCKS}] tensor on "
                         f"{dev}")
    with _lock, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream)
        _launch_pack(lib, groups, bufs, part_ids, n_parts, capacity, None,
                     counts, slots, dev, stream, ws,
                     _route(ws, T, n_parts, dev), clocks=clocks)
        launches += 1
    return bufs, counts, slots


def pack_by_key(groups: list[torch.Tensor], key: torch.Tensor, n_parts: int):
    """The shuffle producer's pack: partition p of row i is
    splitmix64(key[i]) mod n_parts (``relational.ops.partition_ids``),
    capacity is the largest partition, so nothing drops.
    groups: row blocks [T, d_g] as for ``pack``; key [T] of an integer type
    (cast to int64 first, as ``hash_key`` does).
    -> ([buf_g [n_parts, capacity, d_g]], counts (a list of n_parts ints,
        read to the host once), part_ids [T] int32). The float groups'
    buffers are differentiable through ``plain_pack`` over the ids this
    call computed."""
    n = len(groups)
    host: list[int] = []                # the launch's counts, read once

    def launch(*t):
        bufs, counts, ids = _launch_by_key(list(t[:n]), t[n], n_parts)
        host.extend(counts)
        return (*bufs, ids)

    def plain(*t):
        ids = out[-1]
        bufs, _, _ = plain_pack(list(t[:n]), ids, n_parts, max(host))
        return (*bufs, ids)

    out = kernel_call(launch, plain, *groups, key)
    return list(out[:n]), host, out[n]


def _launch_by_key(groups: list[torch.Tensor], key: torch.Tensor,
                   n_parts: int):
    """One ``pack_by_key`` call of the kernels, without autograd."""
    global launches
    if key.dtype.is_floating_point or key.dtype.is_complex:
        raise ValueError(f"the partition key must be an integer column, got "
                         f"{key.dtype}")
    if key.dim() != 1:
        raise ValueError(f"the key must be 1-D, got {tuple(key.shape)}")
    T = key.shape[0]
    if T >= 2 ** 31:
        raise ValueError(f"{T} rows: the kernel indexes rows in int32")
    _check_parts(n_parts)
    dev = key.device
    _check_groups(groups, T, dev)
    _cuda(dev)
    if T == 0:
        return ([torch.empty((n_parts, 0, g.shape[1]), dtype=g.dtype,
                             device=dev) for g in groups], [0] * n_parts,
                torch.empty(0, dtype=torch.int32, device=dev))
    key = key.to(torch.int64).contiguous()
    lib = _lib()
    ids = torch.empty(T, dtype=torch.int32, device=dev)
    counts = torch.empty(n_parts, dtype=torch.int32, device=dev)
    # the tiles' histograms go straight into the pack's look-back words
    # (or multi-pass counts), so the lock spans both launches and the sync
    with _lock, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream)
        route = _route(ws, T, n_parts, dev)
        lookback, _, epoch, scratch = route
        _check(lib, lib.pp_hash_count(
            key.data_ptr(), T, n_parts, ids.data_ptr(), ws.acc.data_ptr(),
            counts.data_ptr(), ws.ticket(1), ws.hash(lib.pp_hash_blocks(T)),
            ws.status.data_ptr() if lookback else None, epoch,
            None if lookback else scratch.data_ptr(), stream),
            "pp_hash_count", dev, stream)
        host = counts.tolist()                   # the call's one host sync
        capacity = max(host)
        bufs = [torch.empty((n_parts, capacity, g.shape[1]), dtype=g.dtype,
                            device=dev) for g in groups]
        _launch_pack(lib, groups, bufs, ids, n_parts, capacity, counts,
                     None, None, dev, stream, ws, route, published=True)
        launches += 1
    return bufs, host, ids
