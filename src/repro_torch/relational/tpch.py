"""TPC-H schema, data generator, and query plans.

Generator: seeded, vectorized; cardinalities scale with `sf` (sf=1 is the
1GB-class standard). Dates are int32 days since 1970-01-01. Low-cardinality
strings are DictColumns (the format's dictionary encoding, §3.2).

Queries: the representative subset Q1, Q3, Q5, Q6, Q12, Q14 — covering the
paper's patterns: pure scan-aggregate (Q1/Q6), 2-table join-aggregate
(Q12/Q14, the paper's running example is Q12), and multi-join (Q3, Q5).
Each is a *physical plan* (core/plan.py): stages of scan / shuffle-join /
partial + final aggregation, exactly the decomposition of §4.
"""
from __future__ import annotations

import datetime

import numpy as np

from repro_torch.relational.table import DictColumn, Table

BASE = {
    "lineitem": 6_001_215, "orders": 1_500_000, "customer": 150_000,
    "part": 200_000, "supplier": 10_000, "partsupp": 800_000,
    "nation": 25, "region": 5,
}

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


DATE_LO = _days(1992, 1, 1)
DATE_HI = _days(1998, 8, 2)

NATIONS = [b"ALGERIA", b"ARGENTINA", b"BRAZIL", b"CANADA", b"EGYPT",
           b"ETHIOPIA", b"FRANCE", b"GERMANY", b"INDIA", b"INDONESIA",
           b"IRAN", b"IRAQ", b"JAPAN", b"JORDAN", b"KENYA", b"MOROCCO",
           b"MOZAMBIQUE", b"PERU", b"CHINA", b"ROMANIA", b"SAUDI ARABIA",
           b"VIETNAM", b"RUSSIA", b"UNITED KINGDOM", b"UNITED STATES"]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
REGIONS = [b"AFRICA", b"AMERICA", b"ASIA", b"EUROPE", b"MIDDLE EAST"]
SEGMENTS = [b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"HOUSEHOLD",
            b"MACHINERY"]
SHIPMODES = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"REG AIR", b"SHIP", b"TRUCK"]
PRIORITIES = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
              b"5-LOW"]
RETURNFLAGS = [b"A", b"N", b"R"]
LINESTATUS = [b"F", b"O"]
TYPES = [f"{a} {b} {c}".encode() for a in
         ("ECONOMY", "LARGE", "MEDIUM", "PROMO", "SMALL", "STANDARD")
         for b in ("ANODIZED", "BRUSHED", "BURNISHED", "PLATED", "POLISHED")
         for c in ("BRASS", "COPPER", "NICKEL", "STEEL", "TIN")]


def _dict(rng, n, values, p=None) -> DictColumn:
    codes = rng.choice(len(values), size=n, p=p).astype(np.uint32)
    return DictColumn(codes, list(values))


def generate(sf: float, seed: int = 7) -> dict[str, Table]:
    """All eight TPC-H tables at scale factor sf."""
    rng = np.random.default_rng(seed)
    n_li = max(int(BASE["lineitem"] * sf), 100)
    n_ord = max(int(BASE["orders"] * sf), 25)
    n_cust = max(int(BASE["customer"] * sf), 10)
    n_part = max(int(BASE["part"] * sf), 10)
    n_supp = max(int(BASE["supplier"] * sf), 5)
    n_ps = max(int(BASE["partsupp"] * sf), 20)

    region = Table({
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": DictColumn(np.arange(5, dtype=np.uint32), REGIONS)})
    nation = Table({
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_regionkey": np.asarray(NATION_REGION, np.int64),
        "n_name": DictColumn(np.arange(25, dtype=np.uint32), NATIONS)})
    customer = Table({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_nationkey": rng.integers(0, 25, n_cust).astype(np.int64),
        "c_acctbal": rng.uniform(-999, 9999, n_cust).round(2),
        "c_mktsegment": _dict(rng, n_cust, SEGMENTS)})
    supplier = Table({
        "s_suppkey": np.arange(n_supp, dtype=np.int64),
        "s_nationkey": rng.integers(0, 25, n_supp).astype(np.int64),
        "s_acctbal": rng.uniform(-999, 9999, n_supp).round(2)})
    part = Table({
        "p_partkey": np.arange(n_part, dtype=np.int64),
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_retailprice": rng.uniform(900, 2000, n_part).round(2),
        "p_type": _dict(rng, n_part, TYPES)})
    partsupp = Table({
        "ps_partkey": rng.integers(0, n_part, n_ps).astype(np.int64),
        "ps_suppkey": rng.integers(0, n_supp, n_ps).astype(np.int64),
        "ps_supplycost": rng.uniform(1, 1000, n_ps).round(2),
        "ps_availqty": rng.integers(1, 10000, n_ps).astype(np.int64)})

    o_date = rng.integers(DATE_LO, DATE_HI - 151, n_ord).astype(np.int32)
    orders = Table({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int64),
        "o_orderdate": o_date,
        "o_totalprice": rng.uniform(800, 500000, n_ord).round(2),
        "o_shippriority": np.zeros(n_ord, np.int64),
        "o_orderpriority": _dict(rng, n_ord, PRIORITIES)})

    l_order = rng.integers(0, n_ord, n_li).astype(np.int64)
    ship_delay = rng.integers(1, 122, n_li).astype(np.int32)
    l_ship = o_date[l_order] + ship_delay
    l_commit = l_ship + rng.integers(-30, 61, n_li).astype(np.int32)
    l_receipt = l_ship + rng.integers(1, 31, n_li).astype(np.int32)
    qty = rng.integers(1, 51, n_li).astype(np.float64)
    price = qty * rng.uniform(900, 11000, n_li).round(2) / 10.0
    lineitem = Table({
        "l_orderkey": l_order,
        "l_partkey": rng.integers(0, n_part, n_li).astype(np.int64),
        "l_suppkey": rng.integers(0, n_supp, n_li).astype(np.int64),
        "l_quantity": qty,
        "l_extendedprice": price.round(2),
        "l_discount": rng.integers(0, 11, n_li) / 100.0,
        "l_tax": rng.integers(0, 9, n_li) / 100.0,
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_returnflag": _dict(rng, n_li, RETURNFLAGS),
        "l_linestatus": _dict(rng, n_li, LINESTATUS),
        "l_shipmode": _dict(rng, n_li, SHIPMODES),
    })
    return {"region": region, "nation": nation, "customer": customer,
            "supplier": supplier, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


# ---------------------------------------------------------------------------
# query plans (physical; see core/plan.py for the schema)
# ---------------------------------------------------------------------------

def q1_plan(ntasks: dict | None = None) -> dict:
    nt = ntasks or {}
    d = _days(1998, 9, 2) - 90
    aggs = [["sum_qty", "sum", "l_quantity"],
            ["sum_base_price", "sum", "l_extendedprice"],
            ["sum_disc_price", "sum", {"fn": "mul", "args": [
                "l_extendedprice",
                {"fn": "one_minus", "args": ["l_discount"]}]}],
            ["avg_qty", "avg", "l_quantity"],
            ["count_order", "count", None]]
    keys = ["l_returnflag", "l_linestatus"]
    return {"name": "q1", "stages": [
        {"name": "scan_agg", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan", 0),
         "columns": ["l_returnflag", "l_linestatus", "l_quantity",
                     "l_extendedprice", "l_discount", "l_shipdate"],
         "ops": [{"op": "filter",
                  "pred": {"fn": "le", "args": ["l_shipdate", d]}},
                 {"op": "partial_agg", "keys": keys, "aggs": aggs}],
         "deps": []},
        {"name": "final", "kind": "final_agg", "tasks": 1,
         "keys": keys, "aggs": aggs,
         "sort": [["l_returnflag", True], ["l_linestatus", True]],
         "deps": ["scan_agg"]},
    ]}


def q6_plan(ntasks: dict | None = None) -> dict:
    nt = ntasks or {}
    lo, hi = _days(1994, 1, 1), _days(1995, 1, 1)
    aggs = [["revenue", "sum", {"fn": "mul",
                                "args": ["l_extendedprice", "l_discount"]}]]
    return {"name": "q6", "stages": [
        {"name": "scan_agg", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan", 0),
         "columns": ["l_shipdate", "l_discount", "l_quantity",
                     "l_extendedprice"],
         "ops": [{"op": "filter", "pred": {"fn": "and", "args": [
                     {"fn": "and", "args": [
                         {"fn": "ge", "args": ["l_shipdate", lo]},
                         {"fn": "lt", "args": ["l_shipdate", hi]}]},
                     {"fn": "and", "args": [
                         {"fn": "ge", "args": ["l_discount", 0.05]},
                         {"fn": "and", "args": [
                             {"fn": "le", "args": ["l_discount", 0.07]},
                             {"fn": "lt", "args": ["l_quantity", 24]}]}]}]}},
                 {"op": "partial_agg", "keys": [], "aggs": aggs}],
         "deps": []},
        {"name": "final", "kind": "final_agg", "tasks": 1, "keys": [],
         "aggs": aggs, "deps": ["scan_agg"]},
    ]}


def q12_plan(ntasks: dict | None = None, shuffle: dict | None = None) -> dict:
    """The paper's running example: lineitem JOIN orders, group by shipmode."""
    nt = ntasks or {}
    lo, hi = _days(1994, 1, 1), _days(1995, 1, 1)
    aggs = [["high_line_count", "sum", {"fn": "mul", "args": [
                {"fn": "or", "args": [
                    {"fn": "eq", "args": ["o_orderpriority",
                                          {"code": ["o_orderpriority",
                                                    "1-URGENT"]}]},
                    {"fn": "eq", "args": ["o_orderpriority",
                                          {"code": ["o_orderpriority",
                                                    "2-HIGH"]}]}]},
                {"const": 1}]}],
            ["low_line_count", "sum", {"fn": "mul", "args": [
                {"fn": "not", "args": [{"fn": "or", "args": [
                    {"fn": "eq", "args": ["o_orderpriority",
                                          {"code": ["o_orderpriority",
                                                    "1-URGENT"]}]},
                    {"fn": "eq", "args": ["o_orderpriority",
                                          {"code": ["o_orderpriority",
                                                    "2-HIGH"]}]}]}]},
                {"const": 1}]}]]
    return {"name": "q12", "stages": [
        {"name": "scan_li", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan_li", 0),
         "columns": ["l_orderkey", "l_shipmode", "l_shipdate",
                     "l_commitdate", "l_receiptdate"],
         "ops": [{"op": "filter", "pred": {"fn": "and", "args": [
                     {"fn": "in", "args": [
                         "l_shipmode", {"code": ["l_shipmode", "MAIL"]},
                         {"code": ["l_shipmode", "SHIP"]}]},
                     {"fn": "and", "args": [
                         {"fn": "lt", "args": ["l_commitdate",
                                               "l_receiptdate"]},
                         {"fn": "and", "args": [
                             {"fn": "lt", "args": ["l_shipdate",
                                                   "l_commitdate"]},
                             {"fn": "and", "args": [
                                 {"fn": "ge", "args": ["l_receiptdate", lo]},
                                 {"fn": "lt", "args": ["l_receiptdate",
                                                       hi]}]}]}]}]}}],
         "partition": {"key": "l_orderkey"}, "deps": []},
        {"name": "scan_ord", "kind": "scan", "table": "orders",
         "tasks": nt.get("scan_ord", 0),
         "columns": ["o_orderkey", "o_orderpriority"],
         "ops": [], "partition": {"key": "o_orderkey"}, "deps": []},
        {"name": "join", "kind": "join", "tasks": nt.get("join", 8),
         "left": "scan_li", "right": "scan_ord",
         "lkey": "l_orderkey", "rkey": "o_orderkey",
         "ops": [{"op": "partial_agg", "keys": ["l_shipmode"],
                  "aggs": aggs}],
         "shuffle": shuffle or {}, "deps": ["scan_li", "scan_ord"]},
        {"name": "final", "kind": "final_agg", "tasks": 1,
         "keys": ["l_shipmode"], "aggs": aggs,
         "sort": [["l_shipmode", True]], "deps": ["join"]},
    ]}


def q3_plan(ntasks: dict | None = None) -> dict:
    nt = ntasks or {}
    d = _days(1995, 3, 15)
    aggs = [["revenue", "sum", {"fn": "mul", "args": [
                "l_extendedprice",
                {"fn": "one_minus", "args": ["l_discount"]}]}]]
    return {"name": "q3", "stages": [
        {"name": "scan_cust", "kind": "scan", "table": "customer",
         "tasks": nt.get("scan_cust", 0),
         "columns": ["c_custkey", "c_mktsegment"],
         "ops": [{"op": "filter", "pred": {"fn": "eq", "args": [
             "c_mktsegment", {"code": ["c_mktsegment", "BUILDING"]}]}}],
         "partition": {"key": "c_custkey"}, "deps": []},
        {"name": "scan_ord", "kind": "scan", "table": "orders",
         "tasks": nt.get("scan_ord", 0),
         "columns": ["o_orderkey", "o_custkey", "o_orderdate",
                     "o_shippriority"],
         "ops": [{"op": "filter",
                  "pred": {"fn": "lt", "args": ["o_orderdate", d]}}],
         "partition": {"key": "o_custkey"}, "deps": []},
        {"name": "join_co", "kind": "join", "tasks": nt.get("join_co", 4),
         "left": "scan_ord", "right": "scan_cust",
         "lkey": "o_custkey", "rkey": "c_custkey",
         "ops": [], "partition": {"key": "o_orderkey"},
         "deps": ["scan_ord", "scan_cust"]},
        {"name": "scan_li", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan_li", 0),
         "columns": ["l_orderkey", "l_extendedprice", "l_discount",
                     "l_shipdate"],
         "ops": [{"op": "filter",
                  "pred": {"fn": "gt", "args": ["l_shipdate", d]}}],
         "partition": {"key": "l_orderkey"}, "deps": []},
        {"name": "join_l", "kind": "join", "tasks": nt.get("join_l", 8),
         "left": "scan_li", "right": "join_co",
         "lkey": "l_orderkey", "rkey": "o_orderkey",
         "ops": [{"op": "partial_agg",
                  "keys": ["l_orderkey", "o_orderdate", "o_shippriority"],
                  "aggs": aggs}],
         "deps": ["scan_li", "join_co"]},
        {"name": "final", "kind": "final_agg", "tasks": 1,
         "keys": ["l_orderkey", "o_orderdate", "o_shippriority"],
         "aggs": aggs,
         "sort": [["revenue", False], ["o_orderdate", True]], "limit": 10,
         "deps": ["join_l"]},
    ]}


def q5_plan(ntasks: dict | None = None) -> dict:
    nt = ntasks or {}
    lo, hi = _days(1994, 1, 1), _days(1995, 1, 1)
    aggs = [["revenue", "sum", {"fn": "mul", "args": [
                "l_extendedprice",
                {"fn": "one_minus", "args": ["l_discount"]}]}]]
    return {"name": "q5", "stages": [
        # broadcast side: ASIA customers (customer x nation x region done at
        # the coordinator-free scan via small-table broadcast join)
        {"name": "scan_cust", "kind": "scan", "table": "customer",
         "tasks": nt.get("scan_cust", 0),
         "columns": ["c_custkey", "c_nationkey"],
         "ops": [{"op": "broadcast_join", "table": "nation",
                  "lkey": "c_nationkey", "rkey": "n_nationkey"},
                 {"op": "broadcast_join", "table": "region",
                  "lkey": "n_regionkey", "rkey": "r_regionkey"},
                 {"op": "filter", "pred": {"fn": "eq", "args": [
                     "r_name", {"code": ["r_name", "ASIA"]}]}}],
         "partition": {"key": "c_custkey"}, "deps": []},
        {"name": "scan_ord", "kind": "scan", "table": "orders",
         "tasks": nt.get("scan_ord", 0),
         "columns": ["o_orderkey", "o_custkey", "o_orderdate"],
         "ops": [{"op": "filter", "pred": {"fn": "and", "args": [
             {"fn": "ge", "args": ["o_orderdate", lo]},
             {"fn": "lt", "args": ["o_orderdate", hi]}]}}],
         "partition": {"key": "o_custkey"}, "deps": []},
        {"name": "join_co", "kind": "join", "tasks": nt.get("join_co", 4),
         "left": "scan_ord", "right": "scan_cust",
         "lkey": "o_custkey", "rkey": "c_custkey",
         "ops": [], "partition": {"key": "o_orderkey"},
         "deps": ["scan_ord", "scan_cust"]},
        {"name": "scan_li", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan_li", 0),
         "columns": ["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount"],
         "ops": [{"op": "broadcast_join", "table": "supplier",
                  "lkey": "l_suppkey", "rkey": "s_suppkey"}],
         "partition": {"key": "l_orderkey"}, "deps": []},
        {"name": "join_l", "kind": "join", "tasks": nt.get("join_l", 8),
         "left": "scan_li", "right": "join_co",
         "lkey": "l_orderkey", "rkey": "o_orderkey",
         # nation of supplier must equal nation of customer
         "ops": [{"op": "filter", "pred": {"fn": "eq", "args": [
                     "s_nationkey", "c_nationkey"]}},
                 {"op": "partial_agg", "keys": ["n_name"], "aggs": aggs}],
         "deps": ["scan_li", "join_co"]},
        {"name": "final", "kind": "final_agg", "tasks": 1,
         "keys": ["n_name"], "aggs": aggs,
         "sort": [["revenue", False]], "deps": ["join_l"]},
    ]}


def q14_plan(ntasks: dict | None = None) -> dict:
    nt = ntasks or {}
    lo, hi = _days(1995, 9, 1), _days(1995, 10, 1)
    # PROMO* types occupy a contiguous code block in the TYPES dictionary
    aggs = [["promo", "sum", {"fn": "mul", "args": [
                {"fn": "and", "args": [
                    {"fn": "ge", "args": ["p_type",
                        {"code": ["p_type", "PROMO ANODIZED BRASS"]}]},
                    {"fn": "lt", "args": ["p_type",
                        {"code": ["p_type", "SMALL ANODIZED BRASS"]}]}]},
                {"fn": "mul", "args": [
                    "l_extendedprice",
                    {"fn": "one_minus", "args": ["l_discount"]}]}]}],
            ["total", "sum", {"fn": "mul", "args": [
                "l_extendedprice",
                {"fn": "one_minus", "args": ["l_discount"]}]}]]
    return {"name": "q14", "stages": [
        {"name": "scan_li", "kind": "scan", "table": "lineitem",
         "tasks": nt.get("scan_li", 0),
         "columns": ["l_partkey", "l_extendedprice", "l_discount",
                     "l_shipdate"],
         "ops": [{"op": "filter", "pred": {"fn": "and", "args": [
             {"fn": "ge", "args": ["l_shipdate", lo]},
             {"fn": "lt", "args": ["l_shipdate", hi]}]}}],
         "partition": {"key": "l_partkey"}, "deps": []},
        {"name": "scan_part", "kind": "scan", "table": "part",
         "tasks": nt.get("scan_part", 0),
         "columns": ["p_partkey", "p_type"],
         "ops": [], "partition": {"key": "p_partkey"}, "deps": []},
        {"name": "join", "kind": "join", "tasks": nt.get("join", 4),
         "left": "scan_li", "right": "scan_part",
         "lkey": "l_partkey", "rkey": "p_partkey",
         "ops": [{"op": "partial_agg", "keys": [], "aggs": aggs}],
         "deps": ["scan_li", "scan_part"]},
        {"name": "final", "kind": "final_agg", "tasks": 1, "keys": [],
         "aggs": aggs, "deps": ["join"]},
    ]}


QUERIES = {"q1": q1_plan, "q3": q3_plan, "q5": q5_plan, "q6": q6_plan,
           "q12": q12_plan, "q14": q14_plan}
