"""The port's tables at the store boundary: the generator gives the same
data, and every serializer writes the same bytes as the numpy engine's
(request counts and virtual latencies depend on those byte sizes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.relational import ops as R  # noqa: E402
from repro.relational import table as RT  # noqa: E402
from repro.relational.tpch import generate as ref_generate  # noqa: E402
from repro_torch.relational import ops as P  # noqa: E402
from repro_torch.relational import table as PT  # noqa: E402
from repro_torch.relational.tpch import generate  # noqa: E402


@pytest.fixture(scope="module")
def both():
    return ref_generate(0.01, seed=5), generate(0.01, seed=5)


def test_generate_identical(both):
    ref, port = both
    assert list(ref) == list(port)
    for name in ref:
        assert ref[name].column_names() == port[name].column_names()
        for n, w in ref[name].cols.items():
            g = port[name][n]
            if isinstance(w, RT.DictColumn):
                assert g.values == w.values
                assert g.codes.dtype == torch.int32
                np.testing.assert_array_equal(g.codes.numpy(), w.codes)
            else:
                assert g.device.type == "cpu"
                assert g.numpy().dtype == w.dtype
                np.testing.assert_array_equal(g.numpy(), w)


def test_serialize_table_bytes_identical(both):
    ref, port = both
    for name in ref:
        want = RT.serialize_table(ref[name])
        assert PT.serialize_table(port[name]) == want, name
        back = PT.deserialize_table(want)
        assert PT.serialize_table(back) == want, name
        sub = ["l_orderkey", "l_shipmode"] if name == "lineitem" else None
        if sub:
            assert PT.serialize_table(PT.deserialize_table(want, sub)) == \
                RT.serialize_table(RT.deserialize_table(want, sub))


def test_table_to_object_bytes_identical(both):
    ref, port = both
    for name in ref:
        want = RT.table_to_object(ref[name])
        assert PT.table_to_object(port[name]) == want, name
        assert PT.table_to_object(PT.decode_object(want)) == want, name
    empty = RT.table_to_object(ref["orders"].take(np.arange(0)))
    assert PT.table_to_object(port["orders"].take(torch.arange(0))) == empty


@pytest.mark.parametrize("n", [1, 4, 8])
def test_partitions_to_object_bytes_identical(both, n):
    ref, port = both
    cols = ["o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority"]
    want = RT.partitions_to_object(
        R.op_partition(ref["orders"].project(cols), "o_custkey", n))
    got = PT.partitions_to_object(
        P.op_partition(port["orders"].project(cols), "o_custkey", n))
    assert got == want
    assert PT.partitions_to_object([PT.Table({})] * n) == \
        RT.partitions_to_object([RT.Table({})] * n)
    assert PT.object_meta(got) == RT.object_meta(want)


def test_segments_and_stats(both):
    ref, port = both
    for n in ("l_shipmode", "l_discount", "l_receiptdate"):
        want = RT.serialize_segment(ref["lineitem"][n])
        assert PT.serialize_segment(port["lineitem"][n]) == want
        assert PT.column_stats(port["lineitem"][n]) == \
            RT.column_stats(ref["lineitem"][n])
        assert PT.serialize_segment(PT.deserialize_segment(want)) == want
    assert PT.read_stats(PT.serialize_table(port["part"])) == \
        RT.read_stats(RT.serialize_table(ref["part"]))


def test_concat_merges_dictionaries():
    a = PT.DictColumn.from_strings([b"x", b"b", b"x"])
    b = PT.DictColumn.from_strings([b"a", b"x"])
    t = PT.Table.concat([PT.Table({"s": a}), PT.Table({"s": b})])
    ra = RT.DictColumn.from_strings([b"x", b"b", b"x"])
    rb = RT.DictColumn.from_strings([b"a", b"x"])
    rt = RT.Table.concat([RT.Table({"s": ra}), RT.Table({"s": rb})])
    assert t["s"].decode() == rt["s"].decode()
    assert t["s"].values == rt["s"].values
    assert PT.serialize_table(t) == RT.serialize_table(rt)


@pytest.mark.parametrize("name", ["orders", "lineitem", "part"])
def test_table_segments_round_trip_as_the_reference(both, name):
    """``table_segments``: the reference's names, segment bytes (byte for
    byte) and zone maps; ``segments_to_table`` of those bytes: the same
    table, whose segments are the same bytes again."""
    ref, port = both
    names, segs, stats = PT.table_segments(port[name])
    want = RT.table_segments(ref[name])
    assert (names, segs, stats) == want
    back = PT.segments_to_table(names, segs)
    assert back.column_names() == names
    assert PT.serialize_table(back) == RT.serialize_table(
        RT.segments_to_table(*want[:2]))
    assert PT.table_segments(back) == want
