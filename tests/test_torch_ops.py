"""Relational operators of the PyTorch port against the numpy engine's, on
the same generate(0.01) tables carried across with ``from_numpy``.

Row sets and orders are exact. Group sums compare at rtol 1e-12: the port
adds with ``index_add_`` where numpy uses ``bincount``, which may order
the additions differently."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.relational import ops as R  # noqa: E402
from repro.relational.table import DictColumn as RDict  # noqa: E402
from repro.relational.table import Table as RTable  # noqa: E402
from repro.relational.tpch import generate  # noqa: E402
from repro_torch.relational import ops as P  # noqa: E402
from repro_torch.relational.table import DictColumn, from_numpy  # noqa: E402


def _np_cols(t):
    return {n: (c.codes, c.values) if isinstance(c, RDict) else c
            for n, c in t.cols.items()}


def _port(t):
    return from_numpy({"t": _np_cols(t)})["t"]


def assert_same_table(got, want, rtol=0.0):
    assert got.column_names() == want.column_names()
    assert len(got) == len(want)
    for n in want.column_names():
        g, w = got[n], want[n]
        if isinstance(w, RDict):
            assert isinstance(g, DictColumn), n
            assert g.values == w.values, n
            np.testing.assert_array_equal(g.codes.numpy(),
                                          w.codes.astype(np.int64), n)
            continue
        g = g.numpy()
        assert g.dtype == w.dtype, (n, g.dtype, w.dtype)
        if rtol and w.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, n)


@pytest.fixture(scope="module")
def tables():
    ref = generate(0.01, seed=11)
    return ref, from_numpy({k: _np_cols(t) for k, t in ref.items()})


EDGE_KEYS = [0, -1, 2 ** 63 - 1, -2 ** 63, 1, 2 ** 32, -2 ** 32]


def test_hash_key_edges_and_random():
    keys = np.concatenate([np.asarray(EDGE_KEYS, np.int64),
                           np.random.default_rng(0).integers(
                               -2 ** 63, 2 ** 63 - 1, 4096, np.int64)])
    got = P.hash_key(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, R.hash_key(keys))


@pytest.mark.parametrize("n", [1, 3, 8, 64])
def test_op_partition_membership_and_order(tables, n):
    ref, port = tables
    cols = ["l_orderkey", "l_quantity", "l_shipdate", "l_shipmode"]
    want = R.op_partition(ref["lineitem"].project(cols), "l_orderkey", n)
    got = P.op_partition(port["lineitem"].project(cols), "l_orderkey", n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert_same_table(g, w)


def test_op_join(tables):
    ref, port = tables
    want = R.op_join(ref["lineitem"], ref["orders"], "l_orderkey",
                     "o_orderkey")
    got = P.op_join(port["lineitem"], port["orders"], "l_orderkey",
                    "o_orderkey")
    assert_same_table(got, want)
    # many-to-many with a clashing column name
    want = R.op_join(ref["partsupp"], ref["partsupp"], "ps_partkey",
                     "ps_partkey", prefix="r_")
    got = P.op_join(port["partsupp"], port["partsupp"], "ps_partkey",
                    "ps_partkey", prefix="r_")
    assert_same_table(got, want)


def test_op_semijoin(tables):
    ref, port = tables
    pred = {"fn": "eq", "args": ["c_mktsegment",
                                 {"code": ["c_mktsegment", "BUILDING"]}]}
    want = R.op_semijoin(ref["orders"], R.op_filter(ref["customer"], pred),
                         "o_custkey", "c_custkey")
    got = P.op_semijoin(port["orders"], P.op_filter(port["customer"], pred),
                        "o_custkey", "c_custkey")
    assert 0 < len(got) < len(port["orders"])
    assert_same_table(got, want)


def test_op_semijoin_empty_right_matches_reference():
    left = {"k": np.arange(3, dtype=np.int64)}
    right = {"k": np.arange(0, dtype=np.int64)}
    with pytest.raises(IndexError):
        R.op_semijoin(RTable(left), RTable(right), "k", "k")
    t = from_numpy({"l": left, "r": right})
    with pytest.raises(IndexError):
        P.op_semijoin(t["l"], t["r"], "k", "k")
    empty = from_numpy({"l": right})["l"]
    assert len(P.op_semijoin(empty, t["r"], "k", "k")) == 0


AGGS = [["sum_qty", "sum", "l_quantity"],
        ["disc_price", "sum", {"fn": "mul", "args": [
            "l_extendedprice", {"fn": "one_minus", "args": ["l_discount"]}]}],
        ["avg_qty", "avg", "l_quantity"],
        ["n", "count", None],
        ["lo", "min", "l_extendedprice"],
        ["hi", "max", "l_shipdate"],
        ["mail", "sum", {"fn": "mul", "args": [
            {"fn": "eq", "args": ["l_shipmode",
                                  {"code": ["l_shipmode", "MAIL"]}]},
            {"const": 1}]}]]


@pytest.mark.parametrize("keys", [[], ["l_returnflag", "l_linestatus"],
                                  ["l_orderkey"], ["l_shipdate",
                                                   "l_shipmode"]])
def test_op_aggregate(tables, keys):
    ref, port = tables
    aggs = [tuple(a) for a in AGGS]
    want = R.op_aggregate(ref["lineitem"], keys, aggs)
    got = P.op_aggregate(port["lineitem"], keys, aggs)
    assert_same_table(got, want, rtol=1e-12)
    np.testing.assert_array_equal(got["n"].numpy(), want["n"])


def test_op_aggregate_empty(tables):
    ref, port = tables
    aggs = [tuple(a) for a in AGGS]
    for keys in ([], ["l_returnflag"]):
        want = R.op_aggregate(ref["lineitem"].take(np.arange(0)), keys, aggs)
        got = P.op_aggregate(port["lineitem"].take(torch.arange(0)), keys,
                             aggs)
        assert_same_table(got, want)


def test_merge_partials(tables):
    ref, port = tables
    keys = ["l_returnflag", "l_linestatus"]
    aggs = [tuple(a) for a in AGGS]
    n = len(ref["lineitem"])
    cuts = [0, n // 3, 2 * n // 3, n]
    want = R.merge_partials(
        [R.op_aggregate(ref["lineitem"].take(np.arange(a, b)), keys, aggs)
         for a, b in zip(cuts, cuts[1:])], keys, aggs)
    got = P.merge_partials(
        [P.op_aggregate(port["lineitem"].take(torch.arange(a, b)), keys,
                        aggs) for a, b in zip(cuts, cuts[1:])], keys, aggs)
    assert_same_table(got, want, rtol=1e-12)


@pytest.mark.parametrize("by,limit", [
    ([("l_shipmode", True), ("l_quantity", False), ("l_orderkey", True)],
     50),
    ([("l_returnflag", False), ("l_shipdate", True)], None),
    ([("l_discount", True)], 7)])
def test_op_sort_limit_exact_order(tables, by, limit):
    ref, port = tables
    want = R.op_sort_limit(ref["lineitem"], by, limit)
    got = P.op_sort_limit(port["lineitem"], by, limit)
    assert_same_table(got, want)


def test_filter_project_compute(tables):
    ref, port = tables
    pred = {"fn": "and", "args": [
        {"fn": "in", "args": ["l_shipmode",
                              {"code": ["l_shipmode", "MAIL"]},
                              {"code": ["l_shipmode", "SHIP"]}]},
        {"fn": "not", "args": [{"fn": "ge", "args": ["l_quantity", 24]}]}]}
    expr = {"fn": "add", "args": ["l_shipdate", 0.5]}
    want = R.op_compute(R.op_project(R.op_filter(ref["lineitem"], pred),
                                     ["l_shipdate", "l_shipmode"]), "x", expr)
    got = P.op_compute(P.op_project(P.op_filter(port["lineitem"], pred),
                                    ["l_shipdate", "l_shipmode"]), "x", expr)
    assert_same_table(got, want)
