"""Relational operators (paper §4.1): data-centric, vectorized, on the
tensors of a Table's device.

Each operator computes what the numpy engine's operator computes, row for
row and in the same order; group sums may differ in the last ulp where the
device adds in another order, but that order is fixed, so the same inputs
give the same bytes on every run (a replayed task's re-PUT must be
byte-identical, §3.2). The shuffle producer's hash-partition runs
through the ``partition_pack`` kernels (hash, counts and pack) on CUDA
tensors and through their plain PyTorch versions on CPU tensors.

Expression mini-language (JSON-able), used by predicates and projections:
  column:      "l_quantity"
  constant:    {"const": 24}
  dict code:   {"code": ["l_shipmode", "MAIL"]}    (string -> code at compile)
  arithmetic:  {"fn": "mul", "args": [...]}        add|sub|mul|one_minus|one_plus
  comparison:  {"fn": "lt",  "args": [...]}        lt|le|gt|ge|eq|ne|in|and|or|not
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels.partition_pack.ops import partition_pack_groups
from repro_torch.kernels.partition_pack.partition_pack import pack_by_key
from repro_torch.relational.table import DictColumn, Table

_ARITH = {"add": operator.add, "sub": operator.sub, "mul": operator.mul}
_CMP = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}


def _promote(a, b):
    """numpy's type promotion where torch's differs: an integer or bool
    tensor meeting a Python float computes in float64 (torch would pick
    float32)."""
    def integral(x):
        return isinstance(x, torch.Tensor) and not x.is_floating_point()
    if isinstance(a, float) and integral(b):
        b = b.double()
    if isinstance(b, float) and integral(a):
        a = a.double()
    return a, b


def eval_expr(t: Table, e):
    if isinstance(e, str):
        c = t[e]
        return c.codes if isinstance(c, DictColumn) else c
    if isinstance(e, (int, float)):
        return e
    if "const" in e:
        return e["const"]
    if "code" in e:
        col, val = e["code"]
        c = t[col]
        assert isinstance(c, DictColumn), col
        return c.code_of(val.encode() if isinstance(val, str) else val)
    fn = e["fn"]
    args = [eval_expr(t, a) for a in e["args"]]
    if fn == "one_minus":
        return operator.sub(*_promote(1.0, args[0]))
    if fn == "one_plus":
        return operator.add(*_promote(1.0, args[0]))
    if fn == "not":
        return torch.logical_not(args[0])
    if fn == "in":
        col = args[0]
        m = torch.zeros(col.shape, dtype=torch.bool, device=col.device)
        for v in args[1:]:
            m |= col == v
        return m
    if fn == "and":
        return torch.logical_and(*args)
    if fn == "or":
        return torch.logical_or(*args)
    if fn in _CMP:
        return _CMP[fn](*args)
    return _ARITH[fn](*_promote(*args))


def op_filter(t: Table, pred) -> Table:
    return t.filter(torch.as_tensor(eval_expr(t, pred)).to(torch.bool))


def op_project(t: Table, columns: list[str]) -> Table:
    return t.project(columns)


def op_compute(t: Table, name: str, expr) -> Table:
    return t.with_column(name, torch.as_tensor(eval_expr(t, expr)))


# ---------------------------------------------------------------------------
# hashing / partitioning
# ---------------------------------------------------------------------------
# splitmix64 runs in uint64 in the numpy engine. Torch lacks shifts on
# uint64, so the same bits are computed in int64: add and multiply wrap in
# two's complement alike, a logical right shift is an arithmetic one with
# the sign bits masked off, and the unsigned remainder is taken from the
# 32-bit halves.

def _i64(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def hash_key(col: torch.Tensor) -> torch.Tensor:
    """splitmix64 of the int64 key; the uint64 result's bits as int64."""
    return _splitmix64(col.to(torch.int64))


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """x mod n with x's int64 bits read as uint64 (n < 2^31)."""
    hi, lo = _srl(x, 32), x & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def partition_ids(col: torch.Tensor, n: int) -> torch.Tensor:
    """Destination partition of each key: splitmix64(key) mod n, int32."""
    return _umod(hash_key(col), n).to(torch.int32)


def width_groups(t: Table):
    """Column name lists of the 8-byte and 4-byte columns, and each
    column's bits as an int64 / int32 view."""
    views = {}
    for n, c in t.cols.items():
        v = c.codes if isinstance(c, DictColumn) else c
        if v.element_size() == 8:
            views[n] = v.view(torch.int64)
        elif v.element_size() == 4:
            views[n] = v.view(torch.int32)
        else:
            raise ValueError(f"column {n!r}: {v.dtype} has no partition "
                             "group (8- and 4-byte columns only)")
    return [[n for n in views if views[n].element_size() == w]
            for w in (8, 4)], views


def op_partition(t: Table, key: str, n: int) -> list[Table]:
    """Hash-partition into n partitions (the shuffle producer side): one
    pack of the table's 8-byte columns stacked as int64 and its 4-byte
    columns stacked as int32, at capacity = the largest partition, so
    nothing drops. Partition p keeps its rows in arrival order.

    On CUDA the hash, the counts and the pack run in the partition_pack
    kernels (``pack_by_key``), with one host sync for the counts; on the
    CPU the plain ``partition_ids`` and ``partition_pack_groups``."""
    names, views = width_groups(t)
    names = [g for g in names if g]
    groups = [torch.stack([views[c] for c in g], 1) for g in names]
    col = t[key]
    if col.device.type == "cuda":
        bufs, counts, _ = pack_by_key(groups, col, n)
    else:
        pid = partition_ids(col, n)
        capacity = int(torch.bincount(pid, minlength=n).max()) \
            if len(t) else 0
        bufs, counts, _ = partition_pack_groups(groups, pid, n_parts=n,
                                                capacity=capacity)
        counts = counts.tolist()
    cols = {}
    for g, buf in zip(names, bufs):
        for j, c in enumerate(g):
            cols[c] = buf[:, :, j]
    parts = []
    for p, cnt in enumerate(counts):
        out = {}
        for c, src in t.cols.items():
            v = cols[c][p, :cnt]
            out[c] = DictColumn(v, src.values) if isinstance(src, DictColumn) \
                else v.view(src.dtype)
        parts.append(Table(out))
    return parts


# ---------------------------------------------------------------------------
# joins (paper §4.1: broadcast + partitioned hash joins)
# ---------------------------------------------------------------------------

def _take(c, idx):
    return c.take(idx) if isinstance(c, DictColumn) else c[idx]


def op_join(left: Table, right: Table, lkey: str, rkey: str,
            prefix: str = "") -> Table:
    """Inner equi-join, general multiplicity, sort-probe (vectorized).

    Probe side = left; build side = right (the smaller relation, as in the
    paper's hash join: build a table from one partition, probe the other).
    """
    lk = left[lkey].to(torch.int64).contiguous()
    rk = right[rkey].to(torch.int64)
    rks, order = torch.sort(rk, stable=True)
    lo = torch.searchsorted(rks, lk, right=False)
    hi = torch.searchsorted(rks, lk, right=True)
    counts = hi - lo
    l_idx = torch.repeat_interleave(
        torch.arange(len(lk), device=lk.device), counts)
    # right match indices: for row i, order[lo[i]:hi[i]]
    offs = torch.repeat_interleave(lo, counts)
    within = torch.arange(len(offs), device=lk.device) - \
        torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    r_idx = order[offs + within]
    out = {n: _take(c, l_idx) for n, c in left.cols.items()}
    for n, c in right.cols.items():
        name = n if n not in out else prefix + n
        out[name] = _take(c, r_idx)
    return Table(out)


def op_semijoin(left: Table, right: Table, lkey: str, rkey: str) -> Table:
    lk = left[lkey].to(torch.int64).contiguous()
    rk = torch.unique(right[rkey].to(torch.int64))
    if len(rk) == 0:
        # the numpy engine indexes the empty key set at -1 here, which
        # raises for any probe row; an out-of-range gather on the device
        # would fault the context instead, so raise the same error first
        if len(lk):
            raise IndexError("index -1 is out of bounds for axis 0 with "
                             "size 0")
        return left
    idx = torch.clamp(torch.searchsorted(rk, lk), 0, len(rk) - 1)
    return left.filter(rk[idx] == lk)


# ---------------------------------------------------------------------------
# aggregation (two-phase, §4.1)
# ---------------------------------------------------------------------------

def _values(c) -> torch.Tensor:
    return c.codes if isinstance(c, DictColumn) else c


_PIECE = 256       # rows of one group a first-level sum on CUDA adds


def _group_sum(v: torch.Tensor, inv: torch.Tensor, ng: int) -> torch.Tensor:
    """float64 sums of v by group id. On the CPU ``index_add_`` adds row
    by row, as numpy's bincount does. On CUDA ``index_add_`` adds through
    atomics in no fixed order. ``index_put_(accumulate=True)`` sorts by
    index and reduces each run of one index in a fixed order, but one warp
    walks a whole run, which is slow for a group of 10^5 rows. So the
    rows, in group order, are summed first in pieces of at most ``_PIECE``
    rows of one group, then the pieces by group. Both levels are
    fixed-order, and no step syncs the host."""
    n = v.shape[0]
    dev = v.device
    if dev.type != "cuda":
        return torch.zeros(ng, dtype=torch.float64, device=dev) \
            .index_add_(0, inv, v)
    order = torch.sort(inv, stable=True).indices
    g = inv[order]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = g[1:] != g[:-1]
    start[::_PIECE] = True
    piece = torch.cumsum(start, 0) - 1
    bound = n // _PIECE + ng + 1          # at least the number of pieces
    sums = torch.zeros(bound, dtype=torch.float64, device=dev) \
        .index_put_((piece,), v[order], accumulate=True)
    owner = torch.full((bound,), ng, dtype=torch.int64, device=dev) \
        .index_put_((piece,), g)          # unused pieces add into slot ng
    return torch.zeros(ng + 1, dtype=torch.float64, device=dev) \
        .index_put_((owner,), sums, accumulate=True)[:ng]


def op_aggregate(t: Table, keys: list[str], aggs: list[tuple]) -> Table:
    """aggs: (out_name, fn, expr). Partial aggregation: avg -> sum+count.
    Groups come out in lexicographic key order; values reduce in float64."""
    n = len(t)
    dev = t.device if t.device is not None else torch.device("cpu")
    if keys:
        combo = torch.stack([_values(t[k]).to(torch.int64) for k in keys], 1)
        if n:
            uniq, inv = torch.unique(combo, dim=0, return_inverse=True)
        else:
            uniq, inv = combo, torch.zeros(0, dtype=torch.int64, device=dev)
        ng = uniq.shape[0]
    else:
        inv = torch.zeros(n, dtype=torch.int64, device=dev)
        ng = 1
    out: dict = {}
    for i, k in enumerate(keys):
        c = t[k]
        if isinstance(c, DictColumn):
            out[k] = DictColumn(uniq[:, i].to(torch.int32), c.values)
        else:
            out[k] = uniq[:, i].to(c.dtype)
    f64 = torch.float64
    for name, fn, expr in aggs:
        v = eval_expr(t, expr) if expr is not None else 1.0
        v = torch.as_tensor(v, dtype=f64, device=dev).expand(n)
        if fn in ("sum", "avg"):
            # numpy's weighted bincount of no rows is int64 zeros; the
            # dtype reaches the serialized partial, so keep it
            out[name] = (_group_sum(v, inv, ng) if n else
                         torch.zeros(ng, dtype=torch.int64, device=dev))
            if fn == "avg":
                out[name + "__count"] = torch.bincount(
                    inv, minlength=ng).to(f64)
        elif fn == "count":
            out[name] = torch.bincount(inv, minlength=ng).to(f64)
        elif fn in ("min", "max"):
            fill = torch.inf if fn == "min" else -torch.inf
            out[name] = torch.full((ng,), fill, dtype=f64, device=dev) \
                .scatter_reduce_(0, inv, v, "amin" if fn == "min" else "amax")
        else:
            raise ValueError(fn)
    return Table(out)


def merge_partials(parts: list[Table], keys: list[str],
                   aggs: list[tuple]) -> Table:
    """Final aggregation: reduce partial aggregates (sums/counts add,
    min/min, max/max), then finish avg = sum/count."""
    t = Table.concat(parts)
    if not len(t):
        return t
    merged_aggs = []
    for name, fn, _ in aggs:
        if fn in ("sum", "count"):
            merged_aggs.append((name, "sum", name))
        elif fn == "avg":
            merged_aggs.append((name, "sum", name))
            merged_aggs.append((name + "__count", "sum", name + "__count"))
        else:
            merged_aggs.append((name, fn, name))
    out = op_aggregate(t, keys, merged_aggs)
    for name, fn, _ in aggs:
        if fn == "avg":
            out.cols[name] = out[name] / torch.clamp(
                out[name + "__count"], min=1)
            del out.cols[name + "__count"]
    return out


def op_sort_limit(t: Table, by: list[tuple], limit: int | None) -> Table:
    """by: list of (column, ascending). The numpy engine's lexsort, as
    stable sorts from the last key to the first."""
    if not len(t):
        return t
    order = torch.arange(len(t), device=t.device)
    for col, asc in reversed(by):
        v = _values(t[col])
        v = v if asc else -v.to(torch.float64)
        order = order[torch.sort(v[order], stable=True).indices]
    if limit is not None:
        order = order[:limit]
    return t.take(order)
