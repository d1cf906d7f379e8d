"""Helpers the port's query-engine parity tests share: what either
package returns (records, summaries, configs, spans) as plain Python
values, so that the two compare with ``==``."""
import dataclasses
import math

import numpy as np

OPTS = dict(sf=0.002, seed=3, target_bytes=200_000, compute_scale=0.0)
_SCALARS = (bool, int, float, str, type(None))


def plain(x, *, strict: bool = True):
    """``x`` as nested dicts and lists of Python scalars (dataclasses by
    field, tuples as lists, NaN as the string "nan"). ``strict`` refuses
    any other leaf (a torch or numpy value that leaked out of a worker);
    otherwise numpy scalars become Python ones."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name), strict=strict)
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k if isinstance(k, (str, int)) else repr(plain(
            k, strict=strict)): plain(v, strict=strict)
            for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v, strict=strict) for v in x]
    if not strict and isinstance(x, np.generic):
        x = x.item()
    if type(x) not in _SCALARS:
        raise TypeError(f"{type(x).__name__} value {x!r} is not plain "
                        "Python")
    return "nan" if isinstance(x, float) and math.isnan(x) else x


def ref(x):
    """The reference's side of a comparison (numpy scalars allowed)."""
    return plain(x, strict=False)


def result_sig(r, *, strict: bool = True) -> dict:
    """A QueryResult without its result table, as plain values."""
    return plain({f.name: getattr(r, f.name)
                  for f in dataclasses.fields(r) if f.name != "result"},
                 strict=strict)


def canon(t) -> dict:
    """A result table's rows sorted by all columns, as float64 arrays."""
    cols = {}
    for n in sorted(t.column_names()):
        c = t[n]
        c = getattr(c, "codes", c)
        c = c.cpu().numpy() if hasattr(c, "cpu") else c
        cols[n] = np.asarray(c, np.float64)
    if not cols:
        return cols
    order = np.lexsort(tuple(cols.values()))
    return {n: v[order] for n, v in cols.items()}


def same_rows(got, want):
    """Result tables equal at the engine test's rtol 1e-9 / atol 1e-6."""
    g, w = canon(got), canon(want)
    assert sorted(g) == sorted(w)
    for n in w:
        np.testing.assert_allclose(g[n], w[n], rtol=1e-9, atol=1e-6,
                                   err_msg=n)
