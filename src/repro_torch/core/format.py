"""Partitioned S3 object format (paper §3.2, Fig 2) — columnar layout.

One producer writes ONE object holding ALL its output partitions, each
partition stored as per-column *segments*:

    [magic u64][n_partitions u64][n_columns u64][dict_len u64]
    [column names: 32-byte fixed slots x C]
    [segment END offsets u64 x (n x C), partition-major]
    [zone maps (min f64, max f64) x (n x C), partition-major]
    [dictionary section (optional)]
    [segment bytes: p0c0 p0c1 ... p0c(C-1) p1c0 ...]        <- the body

A consumer fetches any partition — or any contiguous RUN of partitions —
with exactly TWO range GETs: one for the fixed-size header (its size is a
closed form of (n_partitions, n_columns)), one contiguous byte range
covering the segments it needs. That property is what makes the
multi-stage shuffle (§4.2) work: combiners read contiguous partition runs
at the same 2-reads cost.

The columnar split buys two further pushdowns on SINGLE-partition reads
(base-table scans, join partition reads):
  * projection — the body range covers only the needed columns' segments;
  * predicate skipping — per-segment zone maps (min/max) let a consumer
    prune a partition whose needed column cannot satisfy a bound, shrinking
    the body range (possibly to zero bytes; the GET is still issued so
    request counts stay structural).
Multi-partition runs are read whole: one contiguous range over a
partition-major body necessarily spans every column of the middle
partitions, which is exactly what combiners need anyway.

Dictionary encoding (§3.2): low-cardinality string columns are encoded as
u32 codes; segment payloads embed their dictionaries, and the header keeps
an optional object-level dictionary section for raw-payload users
(runtime/checkpoint).

This module is table-agnostic: it moves opaque segment bytes and their
(min, max) stats. relational/table.py provides the column<->segment codecs.
"""
from __future__ import annotations

import dataclasses
import math
import struct

MAGIC = 0x57A121A6_00000002
_U64 = struct.Struct("<Q")
_NAME_SLOT = 32
_EMPTY_STATS = (math.inf, -math.inf)       # zone map of an empty segment


class FormatError(Exception):
    """A malformed or mismatched partitioned object. Carries the object
    key (when the reader knows it) so failures are actionable."""

    def __init__(self, message: str, key: str | None = None):
        self.key = key
        super().__init__(f"{message} (object {key!r})" if key else message)


def header_size(n_partitions: int, n_columns: int) -> int:
    """Closed form priced by planner/model.py: fixed preamble + name slots
    + (end offset u64 + zone-map 2xf64) per (partition, column)."""
    return 32 + _NAME_SLOT * n_columns + 24 * n_partitions * n_columns


@dataclasses.dataclass
class Header:
    """Parsed header of one partitioned object."""
    n_partitions: int
    columns: list[str]
    ends: list[int]                  # body-relative END offsets, flat p*C+c
    stats: list[tuple[float, float]]  # zone maps, flat p*C+c
    dict_len: int
    data_start: int                  # object offset of the body

    @property
    def n_columns(self) -> int:
        return len(self.columns)

    def seg_bounds(self, part: int, col: int) -> tuple[int, int]:
        """Body-relative [start, end) of one segment."""
        i = part * self.n_columns + col
        return (self.ends[i - 1] if i > 0 else 0), self.ends[i]

    def seg_stats(self, part: int, col: int) -> tuple[float, float]:
        return self.stats[part * self.n_columns + col]


def write_partitioned(columns: list[str],
                      segments: list[list[bytes]],
                      stats: list[list[tuple[float, float]]] | None = None,
                      dictionary: bytes = b"") -> bytes:
    """Serialize ``segments[partition][column]`` into the single-object
    format. ``stats[partition][column] = (min, max)`` zone maps; omitted
    stats default to the empty-segment sentinel (always prunable)."""
    n, c = len(segments), len(columns)
    out = bytearray()
    out += _U64.pack(MAGIC)
    out += _U64.pack(n)
    out += _U64.pack(c)
    out += _U64.pack(len(dictionary))
    for name in columns:
        nb = name.encode()
        if len(nb) > _NAME_SLOT:
            raise FormatError(f"column name {name!r} exceeds the "
                              f"{_NAME_SLOT}-byte header slot")
        out += nb.ljust(_NAME_SLOT, b"\x00")
    pos = 0
    for p, segs in enumerate(segments):
        if len(segs) != c:
            raise FormatError(f"partition {p} has {len(segs)} segments, "
                              f"expected {c}")
        for s in segs:
            pos += len(s)
            out += _U64.pack(pos)
    for p in range(n):
        row = stats[p] if stats is not None else [_EMPTY_STATS] * c
        for lo, hi in row:
            out += struct.pack("<dd", lo, hi)
    out += dictionary
    for segs in segments:
        for s in segs:
            out += s
    return bytes(out)


def parse_header(header: bytes, n_partitions: int | None = None,
                 n_columns: int | None = None, *,
                 key: str | None = None) -> Header:
    """Parse the first ``header_size(n, C)`` bytes (more is fine). The
    expected counts, when given, are validated against the header —
    mismatches raise :class:`FormatError` with the object key context."""
    if len(header) < 32:
        raise FormatError(f"truncated header ({len(header)} bytes)", key)
    magic, n, c, dict_len = struct.unpack_from("<QQQQ", header, 0)
    if magic != MAGIC:
        raise FormatError(f"bad partitioned-object magic {magic:#x}", key)
    if n_partitions is not None and n != n_partitions:
        raise FormatError(f"object has {n} partitions, reader expected "
                          f"{n_partitions}", key)
    if n_columns is not None and c != n_columns:
        raise FormatError(f"object has {c} columns, reader expected "
                          f"{n_columns}", key)
    need = header_size(n, c)
    if len(header) < need:
        raise FormatError(f"header needs {need} bytes, got {len(header)}",
                          key)
    pos = 32
    columns = []
    for _ in range(c):
        raw = header[pos:pos + _NAME_SLOT]
        columns.append(raw.rstrip(b"\x00").decode())
        pos += _NAME_SLOT
    ends = list(struct.unpack_from(f"<{n * c}Q", header, pos)) \
        if n * c else []
    pos += 8 * n * c
    stats = [struct.unpack_from("<dd", header, pos + 16 * i)
             for i in range(n * c)]
    return Header(n, columns, ends, stats, dict_len, need + dict_len)


def partition_range(hdr: Header, first: int, last: int | None = None
                    ) -> tuple[int, int]:
    """Object byte range [start, end) covering ALL columns of partitions
    [first, last] (inclusive). Contiguous runs cost the same two GETs as a
    single partition."""
    last = first if last is None else last
    if hdr.n_columns == 0:
        return hdr.data_start, hdr.data_start
    lo = hdr.seg_bounds(first, 0)[0]
    hi = hdr.seg_bounds(last, hdr.n_columns - 1)[1]
    return hdr.data_start + lo, hdr.data_start + hi


def covering_range(hdr: Header, part: int, col_idx: list[int]
                   ) -> tuple[int, int]:
    """Minimal contiguous object byte range covering the given column
    segments of ONE partition (projection pushdown). Empty selection ->
    a zero-length range (the GET is still issued for structural parity)."""
    if not col_idx:
        return hdr.data_start, hdr.data_start
    lo = hdr.seg_bounds(part, min(col_idx))[0]
    hi = hdr.seg_bounds(part, max(col_idx))[1]
    return hdr.data_start + lo, hdr.data_start + hi


def prune_partition(hdr: Header, part: int,
                    bounds: dict[int, tuple[float, float]]) -> bool:
    """True if zone maps prove NO row of ``part`` can satisfy every bound
    (``bounds[col_idx] = (lo, hi)`` closed interval). Empty segments carry
    the (inf, -inf) sentinel and always prune."""
    for ci, (blo, bhi) in bounds.items():
        slo, shi = hdr.seg_stats(part, ci)
        if shi < blo or slo > bhi:
            return True
    return False


# ---------------------------------------------------------------------------
# dictionary encoding for low-cardinality string columns (§3.2)
# ---------------------------------------------------------------------------

def encode_dictionary(values: list[bytes]) -> bytes:
    out = bytearray()
    out += _U64.pack(len(values))
    for v in values:
        out += _U64.pack(len(v))
        out += v
    return bytes(out)


def decode_dictionary(data: bytes) -> list[bytes]:
    (n,) = _U64.unpack_from(data, 0)
    pos = 8
    vals = []
    for _ in range(n):
        (ln,) = _U64.unpack_from(data, pos)
        pos += 8
        vals.append(bytes(data[pos:pos + ln]))
        pos += ln
    return vals
