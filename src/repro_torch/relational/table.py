"""Columnar tables on one torch device, with ORC-like segment serialization.

A Table is a dict of equal-length columns, all tensors on one device:
  * numeric: int64 / float64 / int32 (dates = days since epoch)
  * low-cardinality strings: DictColumn (int32 codes + dictionary), the
    paper's §3.2 dictionary encoding. The wire format keeps the codes as
    u32; on the device they are int32 (torch's unsigned types lack most
    operators), which holds every dictionary this engine builds.

Numpy arrays handed to ``Table``/``DictColumn`` (the TPC-H generator's
output) are wrapped as CPU tensors. Serialization is the store boundary:
columns go to the host there and only there, and every object is
byte-identical to the one the numpy engine writes for the same rows —
request counts and virtual latencies depend on those byte sizes.
"""
from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from repro_torch.core import format as FMT

_U64 = struct.Struct("<Q")
_DTYPES = {0: np.dtype("<i8"), 1: np.dtype("<f8"), 2: np.dtype("<i4"),
           3: np.dtype("<u4"), 4: np.dtype("<f4")}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def _as_tensor(col) -> torch.Tensor:
    if isinstance(col, torch.Tensor):
        return col
    return torch.from_numpy(np.ascontiguousarray(col))


@dataclasses.dataclass
class DictColumn:
    codes: torch.Tensor                # int32 (u32 on the wire)
    values: list[bytes]                # code -> string

    def __post_init__(self):
        if not isinstance(self.codes, torch.Tensor):
            self.codes = torch.from_numpy(
                np.asarray(self.codes).astype(np.int32))

    def __len__(self):
        return self.codes.shape[0]

    def take(self, idx):
        return DictColumn(self.codes[idx], self.values)

    def to(self, device) -> "DictColumn":
        return DictColumn(self.codes.to(device), self.values)

    def decode(self) -> list[bytes]:
        return [self.values[c] for c in self.codes.tolist()]

    @staticmethod
    def from_strings(strings: list[bytes]) -> "DictColumn":
        vals = sorted(set(strings))
        lut = {v: i for i, v in enumerate(vals)}
        codes = torch.tensor([lut[s] for s in strings], dtype=torch.int32)
        return DictColumn(codes, vals)

    def code_of(self, value: bytes) -> int:
        try:
            return self.values.index(value)
        except ValueError:
            return -1


class Table:
    def __init__(self, cols: dict):
        self.cols = {n: c if isinstance(c, DictColumn) else _as_tensor(c)
                     for n, c in cols.items()}

    def __len__(self):
        for c in self.cols.values():
            return len(c)
        return 0

    def __getitem__(self, name):
        return self.cols[name]

    @property
    def device(self) -> torch.device | None:
        for c in self.cols.values():
            return (c.codes if isinstance(c, DictColumn) else c).device
        return None

    def column_names(self):
        return list(self.cols)

    def project(self, names) -> "Table":
        return Table({n: self.cols[n] for n in names})

    def take(self, idx) -> "Table":
        idx = _as_tensor(idx)
        dev = self.device
        if dev is not None:
            idx = idx.to(dev)
        return Table({n: c.take(idx) if isinstance(c, DictColumn)
                      else c[idx] for n, c in self.cols.items()})

    def filter(self, mask: torch.Tensor) -> "Table":
        return self.take(torch.nonzero(mask).flatten())

    def with_column(self, name, col) -> "Table":
        d = dict(self.cols)
        d[name] = col
        return Table(d)

    def to(self, device) -> "Table":
        return Table({n: c.to(device) for n, c in self.cols.items()})

    @staticmethod
    def concat(tables: list["Table"]) -> "Table":
        tables = [t for t in tables if len(t)]
        if not tables:
            return Table({})
        names = tables[0].column_names()
        out = {}
        for n in names:
            c0 = tables[0][n]
            if isinstance(c0, DictColumn):
                # merge dictionaries: remap each table's codes through a
                # per-table lookup vector (one gather instead of a row loop)
                vals = sorted({v for t in tables for v in t[n].values})
                lut = {v: i for i, v in enumerate(vals)}
                codes = torch.cat([
                    torch.tensor([lut[v] for v in t[n].values],
                                 dtype=torch.int32,
                                 device=t[n].codes.device)[t[n].codes.long()]
                    for t in tables])
                out[n] = DictColumn(codes, vals)
            else:
                out[n] = torch.cat([t[n] for t in tables])
        return Table(out)


def from_numpy(tables: dict, device="cpu") -> dict[str, Table]:
    """``{name: {col: ndarray | (codes_u32, values)}}`` -> port Tables on
    ``device`` — how identical data crosses from the numpy engine."""
    out = {}
    for name, cols in tables.items():
        tc = {}
        for n, c in cols.items():
            if isinstance(c, tuple):
                codes, values = c
                tc[n] = DictColumn(np.asarray(codes), list(values))
            else:
                tc[n] = np.array(c)
        out[name] = Table(tc).to(device)
    return out


# ---------------------------------------------------------------------------
# host side of the store boundary
# ---------------------------------------------------------------------------

def _host(col) -> np.ndarray:
    """Column -> little-endian numpy array as written (codes as <u4)."""
    if isinstance(col, DictColumn):
        return col.codes.cpu().numpy().astype("<u4")
    arr = col.cpu().numpy()
    return arr.astype(arr.dtype.newbyteorder("<"))


def _dict_bytes(values: list[bytes]) -> bytes:
    d = bytearray()
    d += _U64.pack(len(values))
    for v in values:
        d += _U64.pack(len(v))
        d += v
    return bytes(d)


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    # np.frombuffer views are read-only: copy before torch wraps them
    return torch.from_numpy(arr.copy()).to(device)


# ---------------------------------------------------------------------------
# serialization (column segments with stats)
# ---------------------------------------------------------------------------

def serialize_table(t: Table) -> bytes:
    """[ncols u64] then per column:
    [name_len u64][name][kind u8][dtype u8][nrows u64][min f64][max f64]
    [payload] — DictColumn payload embeds its dictionary."""
    out = bytearray()
    out += _U64.pack(len(t.cols))
    for name, col in t.cols.items():
        nb = name.encode()
        out += _U64.pack(len(nb))
        out += nb
        arr = _host(col)
        kind = 1 if isinstance(col, DictColumn) else 0
        out += bytes([kind, _DTYPE_CODES[arr.dtype]])
        out += _U64.pack(len(arr))
        lo = float(arr.min()) if len(arr) else 0.0
        hi = float(arr.max()) if len(arr) else 0.0
        out += struct.pack("<dd", lo, hi)
        if kind:
            d = _dict_bytes(col.values)
            out += _U64.pack(len(d))
            out += d
        out += arr.tobytes()
    return bytes(out)


def read_stats(data: bytes) -> dict:
    """Column min/max stats without decoding payloads (segment skipping)."""
    stats = {}
    (ncols,) = _U64.unpack_from(data, 0)
    pos = 8
    for _ in range(ncols):
        (nl,) = _U64.unpack_from(data, pos); pos += 8
        name = data[pos:pos + nl].decode(); pos += nl
        kind, dt = data[pos], data[pos + 1]; pos += 2
        (n,) = _U64.unpack_from(data, pos); pos += 8
        lo, hi = struct.unpack_from("<dd", data, pos); pos += 16
        stats[name] = (lo, hi)
        if kind == 1:
            (dlen,) = _U64.unpack_from(data, pos); pos += 8 + dlen
            pos += n * 4
        else:
            pos += n * _DTYPES[dt].itemsize
    return stats


# ---------------------------------------------------------------------------
# per-column segments (the §3.2 columnar partitioned-object body)
# ---------------------------------------------------------------------------

def column_stats(col) -> tuple[float, float]:
    """Zone map (min, max) of one column. Empty columns carry the
    (inf, -inf) sentinel, which every bound prunes. DictColumn stats are
    over the codes — per-segment dictionaries make code bounds
    incomparable across segments, so predicate pushdown skips them."""
    if len(col) == 0:
        return (math.inf, -math.inf)
    arr = col.codes if isinstance(col, DictColumn) else col
    return (float(arr.min()), float(arr.max()))


def serialize_segment(col) -> bytes:
    """[kind u8][dtype u8][nrows u64][payload] — DictColumn payloads embed
    their dictionary ([dlen u64][dict][codes u4 x n])."""
    arr = _host(col)
    out = bytearray()
    kind = 1 if isinstance(col, DictColumn) else 0
    out += bytes([kind, _DTYPE_CODES[arr.dtype]])
    out += _U64.pack(len(arr))
    if kind:
        d = _dict_bytes(col.values)
        out += _U64.pack(len(d))
        out += d
    out += arr.tobytes()
    return bytes(out)


def deserialize_segment(data: bytes, device="cpu"):
    """Decode one column segment to a tensor / DictColumn on ``device``."""
    kind, dtc = data[0], data[1]
    (n,) = _U64.unpack_from(data, 2)
    pos = 10
    if kind == 1:
        (dlen,) = _U64.unpack_from(data, pos)
        pos += 8
        dpos = pos
        (nv,) = _U64.unpack_from(data, dpos)
        dpos += 8
        vals = []
        for _ in range(nv):
            (vl,) = _U64.unpack_from(data, dpos)
            dpos += 8
            vals.append(bytes(data[dpos:dpos + vl]))
            dpos += vl
        pos += dlen
        codes = np.frombuffer(data, "<u4", n, pos).astype(np.int32)
        return DictColumn(torch.from_numpy(codes).to(device), vals)
    return _tensor(np.frombuffer(data, _DTYPES[dtc], n, pos), device)


def partitions_to_object(parts: list[Table]) -> bytes:
    """Write the §3.2 columnar partitioned object for one producer's
    output partitions (all share one column set — op_partition slices a
    single table)."""
    parts = [p.to("cpu") for p in parts]
    names: list[str] = []
    for p in parts:
        if p.column_names():
            names = p.column_names()
            break
    empty = torch.empty(0, dtype=torch.int64)
    segs = [[serialize_segment(p[n] if n in p.cols else empty)
             for n in names] for p in parts]
    stats = [[column_stats(p[n]) if n in p.cols else (math.inf, -math.inf)
              for n in names] for p in parts]
    return FMT.write_partitioned(names, segs, stats)


def table_to_object(t: Table) -> bytes:
    """Single-partition columnar object (base-table splits): readable with
    the same two range GETs + projection/zone-map pushdown as shuffle
    intermediates."""
    return partitions_to_object([t])


def decode_object(data: bytes, columns: list[str] | None = None,
                  key: str | None = None, device="cpu") -> Table:
    """Whole-object decode that accepts BOTH wire formats: a §3.2 columnar
    partitioned object (all partitions concatenated) or a plain
    ``serialize_table`` blob — the sniff keeps direct-blob fixtures and
    final-stage outputs readable through one code path."""
    if len(data) >= 8 and _U64.unpack_from(data, 0)[0] == FMT.MAGIC:
        hdr = FMT.parse_header(data, key=key)
        want = [i for i, n in enumerate(hdr.columns)
                if columns is None or n in columns]
        parts = []
        for p in range(hdr.n_partitions):
            cols = {}
            for ci in want:
                lo, hi = hdr.seg_bounds(p, ci)
                cols[hdr.columns[ci]] = deserialize_segment(
                    data[hdr.data_start + lo:hdr.data_start + hi], device)
            parts.append(Table(cols))
        return Table.concat(parts) if len(parts) != 1 else parts[0]
    return deserialize_table(data, columns, device)


def object_meta(data: bytes, key: str | None = None) -> dict | None:
    """Header-derived metadata of a columnar object (planner probe input):
    column order, per-column kinds ("num" | "dict"), per-column total body
    bytes, and per-column zone maps aggregated over partitions. ``None``
    for plain serialize_table blobs."""
    if len(data) < 8 or _U64.unpack_from(data, 0)[0] != FMT.MAGIC:
        return None
    hdr = FMT.parse_header(data, key=key)
    col_bytes = {n: 0 for n in hdr.columns}
    stats = {n: (math.inf, -math.inf) for n in hdr.columns}
    kinds = {}
    for p in range(hdr.n_partitions):
        for ci, n in enumerate(hdr.columns):
            lo, hi = hdr.seg_bounds(p, ci)
            col_bytes[n] += hi - lo
            slo, shi = hdr.seg_stats(p, ci)
            stats[n] = (min(stats[n][0], slo), max(stats[n][1], shi))
            if hi > lo and n not in kinds:
                kinds[n] = "dict" if data[hdr.data_start + lo] == 1 \
                    else "num"
    return {"n_partitions": hdr.n_partitions, "columns": hdr.columns,
            "kinds": {n: kinds.get(n, "num") for n in hdr.columns},
            "col_bytes": col_bytes, "stats": stats,
            "header_bytes": FMT.header_size(hdr.n_partitions,
                                            hdr.n_columns)}


def deserialize_table(data: bytes, columns: list[str] | None = None,
                      device="cpu") -> Table:
    """Column-pruned decode: only `columns` are materialized."""
    cols: dict = {}
    (ncols,) = _U64.unpack_from(data, 0)
    pos = 8
    for _ in range(ncols):
        (nl,) = _U64.unpack_from(data, pos); pos += 8
        name = data[pos:pos + nl].decode(); pos += nl
        kind, dtc = data[pos], data[pos + 1]; pos += 2
        (n,) = _U64.unpack_from(data, pos); pos += 8
        pos += 16                                      # stats
        want = columns is None or name in columns
        if kind == 1:
            (dlen,) = _U64.unpack_from(data, pos); pos += 8
            if want:
                dpos = pos
                (nv,) = _U64.unpack_from(data, dpos); dpos += 8
                vals = []
                for _ in range(nv):
                    (vl,) = _U64.unpack_from(data, dpos); dpos += 8
                    vals.append(bytes(data[dpos:dpos + vl])); dpos += vl
            pos += dlen
            if want:
                codes = np.frombuffer(data, "<u4", n, pos).astype(np.int32)
                cols[name] = DictColumn(torch.from_numpy(codes).to(device),
                                        vals)
            pos += n * 4
        else:
            dt = _DTYPES[dtc]
            if want:
                cols[name] = _tensor(np.frombuffer(data, dt, n, pos), device)
            pos += n * dt.itemsize
    return Table(cols)
