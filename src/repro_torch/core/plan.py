"""Physical query plans (paper §2.3/§4: the coordinator's input is a JSON
physical plan — Starling has no optimizer).

Plan schema (JSON-able dict):
  {"name": str, "stages": [stage, ...]}
stage:
  {"name": str, "kind": "scan"|"join"|"combine"|"final_agg",
   "tasks": int (0 = one per input object),
   "deps": [stage names],
   scan:  "table", "columns", "ops"
   join:  "left"/"right" (stage names), "lkey"/"rkey", "ops",
          "shuffle": {"strategy": "single"|"multi", "p":..., "f":...}
   final_agg: "keys", "aggs", "sort", "limit"
   any stage may have "partition": {"key": col} -> writes the §3.2
   partitioned object format with the consuming stage's task count.}

Task naming: q/<query>/<stage>/t<i>; doublewrite twin appends ".dw".
"""
from __future__ import annotations

import copy
import json
import math

from repro_torch.core import shuffle as SH


def load_plan(text: str) -> dict:
    plan = json.loads(text)
    validate_plan(plan)
    return plan


def dump_plan(plan: dict) -> str:
    return json.dumps(plan, indent=1)


def validate_plan(plan: dict):
    names = set()
    for st in plan["stages"]:
        assert st["name"] not in names, f"duplicate stage {st['name']}"
        for d in st["deps"]:
            assert d in names, f"stage {st['name']} dep {d} not defined yet"
        names.add(st["name"])
        # "modeled": a structural-model stage (workload.tenancy hybrid
        # mode) — occupies real slots for a calibrated duration instead
        # of executing a worker
        assert st["kind"] in ("scan", "join", "combine", "final_agg",
                              "modeled"), st


def stage_by_name(plan: dict, name: str) -> dict:
    for st in plan["stages"]:
        if st["name"] == name:
            return st
    raise KeyError(name)


def out_key(query: str, stage: str, task: int) -> str:
    return f"q/{query}/{stage}/t{task}"


def combine_name(join_stage: str, side: str) -> str:
    """Name of the spliced-in combiner stage feeding ``side`` of a join."""
    return f"{join_stage}__combine_{side}"


def resolved_tasks(plan: dict, split_counts: dict[str, int]) -> dict:
    """Stage name -> realized task count (``tasks=0`` scans get one task
    per base split, exactly like the coordinator)."""
    out = {}
    for st in plan["stages"]:
        if st["kind"] == "scan":
            out[st["name"]] = st["tasks"] or split_counts[st["table"]]
        else:
            out[st["name"]] = max(st.get("tasks", 1), 1)
    return out


# ---------------------------------------------------------------------------
# projection / predicate pushdown inference (§3.1-style scan pruning)
# ---------------------------------------------------------------------------

def expr_refs(e, out: set | None = None) -> set:
    """Column names referenced by an expression of the relational
    mini-language (see relational.ops.eval_expr)."""
    out = set() if out is None else out
    if isinstance(e, str):
        out.add(e)
    elif isinstance(e, dict):
        if "code" in e:
            out.add(e["code"][0])
        elif "fn" in e:
            for a in e["args"]:
                expr_refs(a, out)
    return out


def _agg_refs(keys, aggs) -> set:
    refs = set(keys or ())
    for a in aggs or ():
        if a[2] is not None:
            expr_refs(a[2], refs)
    return refs


def _ops_out_schema(cols: list[str], ops: list,
                    base_schemas: dict) -> list[str] | None:
    """Forward schema inference over a stage's op pipeline. ``None`` when
    an op's output cannot be determined (unknown broadcast table)."""
    cols = list(cols)
    for op in ops:
        k = op["op"]
        if k == "project":
            cols = list(op["columns"])
        elif k == "compute":
            if op["name"] not in cols:
                cols.append(op["name"])
        elif k == "partial_agg":
            cols = list(op["keys"])
            for a in op["aggs"]:
                cols.append(a[0])
                if a[1] == "avg":
                    cols.append(a[0] + "__count")
        elif k == "broadcast_join":
            small = base_schemas.get(op["table"])
            if small is None:
                return None
            for n in small:
                if n not in cols:
                    cols.append(n)
        # filter: schema unchanged
    return cols


def _ops_required(ops: list, required: set, base_schemas: dict) -> set:
    """Backward pass: the columns a stage must READ so its op pipeline can
    produce ``required``. Conservative — ops that must see a column to
    *execute* (project targets, join keys, filter refs) keep it even when
    the output does not carry it."""
    req = set(required)
    for op in reversed(ops):
        k = op["op"]
        if k == "filter":
            expr_refs(op["pred"], req)
        elif k == "project":
            req = set(op["columns"]) | req
        elif k == "compute":
            req.discard(op["name"])
            expr_refs(op["expr"], req)
        elif k == "partial_agg":
            req = _agg_refs(op["keys"], op["aggs"])
        elif k == "broadcast_join":
            small = set(base_schemas.get(op["table"], ()))
            req = (req - small) | {op["lkey"]}
    return req


def _flatten_conjuncts(pred, out: list):
    if isinstance(pred, dict) and pred.get("fn") == "and":
        for a in pred["args"]:
            _flatten_conjuncts(a, out)
    else:
        out.append(pred)


def _leaf_bound(leaf) -> tuple[str, float, float] | None:
    """(column, lo, hi) closed satisfying interval of one comparison
    against constants, else None. Strict bounds are widened to closed ones
    (conservative: a prune must prove NO row can pass)."""
    if not isinstance(leaf, dict) or "fn" not in leaf:
        return None
    fn, args = leaf["fn"], leaf.get("args", ())
    if fn == "in":
        col = args[0]
        vals = [a.get("const") if isinstance(a, dict) else a
                for a in args[1:]]
        if isinstance(col, str) and all(isinstance(v, (int, float))
                                        for v in vals) and vals:
            return (col, float(min(vals)), float(max(vals)))
        return None
    if fn not in ("lt", "le", "gt", "ge", "eq") or len(args) != 2:
        return None
    a, b = args
    if isinstance(b, dict) and "const" in b:
        b = b["const"]
    if isinstance(a, dict) and "const" in a:
        a = a["const"]
    if isinstance(a, str) and isinstance(b, (int, float)):
        col, v, flip = a, float(b), False
    elif isinstance(b, str) and isinstance(a, (int, float)):
        col, v, flip = b, float(a), True
    else:
        return None
    if fn == "eq":
        return (col, v, v)
    lower = fn in ("gt", "ge")
    if flip:
        lower = not lower
    return (col, v, math.inf) if lower else (col, -math.inf, v)


def filter_bounds(ops: list, numeric_cols: set) -> dict:
    """Zone-map-checkable value bounds per base column, extracted from the
    top-level conjuncts of a stage's filter predicates. Only numeric base
    columns qualify (dictionary codes are per-segment, so code bounds do
    not transfer across objects), and only columns no earlier op
    redefined."""
    bounds: dict[str, tuple[float, float]] = {}
    defined: set = set()
    for op in ops:
        if op["op"] == "compute":
            defined.add(op["name"])
        elif op["op"] == "partial_agg":
            break                   # downstream filters see agg outputs
        elif op["op"] == "filter":
            leaves: list = []
            _flatten_conjuncts(op["pred"], leaves)
            for leaf in leaves:
                got = _leaf_bound(leaf)
                if got is None:
                    continue
                col, lo, hi = got
                if col in defined or col not in numeric_cols:
                    continue
                plo, phi = bounds.get(col, (-math.inf, math.inf))
                bounds[col] = (max(plo, lo), min(phi, hi))
    return bounds


def infer_pushdown(plan: dict, base_schemas: dict[str, dict]) -> dict:
    """Annotate an EXPANDED plan (in place) with per-consumer projection
    and predicate pushdown, the read-side contract of the §3.2 columnar
    format:

      * scan stages gain ``_read_cols`` (columns to fetch), ``_read_bounds``
        (zone-map prune intervals) and ``_n_base_cols`` (sizes the header
        GET);
      * join stages gain ``_read_cols = {"left": [...], "right": [...]}``
        applied to their partitioned inputs (combiner outputs carry the
        producer's columns, so name-based selection covers both shuffle
        shapes).

    ``base_schemas[table]`` maps column name -> kind ("num" | "dict") in
    storage order. This is the SINGLE source of the pushdown structure:
    the coordinator annotates its private expanded plan with it and the
    planner's :class:`QueryModel` prices bytes from the very same pass, so
    model and simulator cannot disagree on which segments a consumer
    fetches. Combiners read whole partition runs (a contiguous range over
    a partition-major body spans every column of the middle partitions —
    exactly what a §4.2 merge needs), so they carry no annotation.
    """
    schemas: dict[str, list[str] | None] = {}     # stage -> output columns
    start_cols: dict[str, list[str] | None] = {}  # scan -> readable columns
    for st in plan["stages"]:
        kind = st["kind"]
        if kind == "scan":
            base = base_schemas.get(st["table"])
            cols = st.get("columns") or (list(base) if base else None)
            start_cols[st["name"]] = cols
            schemas[st["name"]] = None if cols is None else \
                _ops_out_schema(cols, st.get("ops", []), base_schemas)
        elif kind == "join":
            ls, rs = schemas.get(st["left"]), schemas.get(st["right"])
            if ls is None or rs is None:
                schemas[st["name"]] = None
                continue
            merged = list(ls) + [n for n in rs if n not in ls]
            schemas[st["name"]] = _ops_out_schema(merged, st.get("ops", []),
                                                  base_schemas)
        elif kind == "combine":
            schemas[st["name"]] = schemas.get(st["source"])
        else:
            schemas[st["name"]] = None
    for st in plan["stages"]:
        out = schemas.get(st["name"])
        if out is not None:
            # producer's written column count: sizes consumers' header GETs
            # (planner/model.py prices header_size(n_parts, _out_ncols))
            st["_out_ncols"] = len(out)

    required: dict[str, set] = {}
    for st in reversed(plan["stages"]):
        kind = st["kind"]
        req = set(required.get(st["name"], ()))
        if st.get("partition"):
            req.add(st["partition"]["key"])
        if kind == "final_agg":
            need = _agg_refs(st.get("keys"), st.get("aggs"))
            for col, _asc in st.get("sort", ()):
                need.add(col)
            # avg partials arrive as sum + __count pairs
            for a in st.get("aggs", ()):
                if a[1] == "avg":
                    need.add(a[0] + "__count")
                need.add(a[0])
            required.setdefault(st["deps"][0], set()).update(need)
        elif kind == "join":
            ls, rs = schemas.get(st["left"]), schemas.get(st["right"])
            before = _ops_required(st.get("ops", []), req, base_schemas)
            if ls is None or rs is None:
                for side in ("left", "right"):
                    required.setdefault(st[side], set()).update(before)
                continue
            # right overwrites left on name collisions (relational.ops)
            need_r = (before & set(rs)) | {st["rkey"]}
            need_l = ((before - set(rs)) & set(ls)) | {st["lkey"]}
            st["_read_cols"] = {"left": sorted(need_l),
                               "right": sorted(need_r)}
            required.setdefault(st["left"], set()).update(need_l)
            required.setdefault(st["right"], set()).update(need_r)
        elif kind == "combine":
            required.setdefault(st["source"], set()).update(req)
        elif kind == "scan":
            base = base_schemas.get(st["table"])
            cols = start_cols.get(st["name"])
            if base is None or cols is None:
                continue            # base objects not columnar: whole-read
            before = _ops_required(st.get("ops", []), req, base_schemas)
            read = sorted((before | set()) & set(cols)) if req or before \
                else sorted(cols)
            numeric = {n for n in cols if base.get(n) == "num"}
            bounds = filter_bounds(st.get("ops", []), numeric)
            st["_read_cols"] = read
            st["_read_bounds"] = {c: list(b) for c, b in bounds.items()
                                  if c in read or c in numeric}
            st["_n_base_cols"] = len(base)
    return plan


def expand_combiners(plan: dict, unique_name: str,
                     split_counts: dict[str, int]) -> dict:
    """Working copy with combiner stages spliced in for every multi-stage
    shuffle join (§4.2), which gains them as deps. The caller's plan object
    is never touched, so re-running the same plan dict is safe.

    This is the SINGLE source of the multi-stage structure: the coordinator
    schedules the expanded stages and the planner's :class:`QueryModel`
    derives its structural request counts from the very same expansion
    (``splits``/``source_parts``/``assign`` annotations below), so model
    and simulator can never disagree on the (p, f) work assignment.
    """
    stages = copy.deepcopy(plan["stages"])
    expanded = {"name": unique_name, "stages": stages}
    counts = resolved_tasks(expanded, split_counts)
    out = []
    for st in stages:
        if st["kind"] == "join" and \
                st.get("shuffle", {}).get("strategy") == "multi":
            r = counts[st["name"]]
            for side_name in ("left", "right"):
                src = st[side_name]
                s = counts[src]
                sh = st["shuffle"]
                a, b = SH.clamped_splits(s, r, sh.get("p", 1 / 4),
                                         sh.get("f", 1 / 4))
                assign = SH.combiner_assignment(
                    SH.multi_stage(s, r, 1.0 / a, 1.0 / b))
                cname = combine_name(st["name"], side_name)
                out.append({"name": cname, "kind": "combine",
                            "source": src, "tasks": len(assign),
                            "assign": assign, "splits": (a, b),
                            "source_parts": r, "deps": [src]})
                st["deps"] = list(st["deps"]) + [cname]
        out.append(st)
    expanded["stages"] = out
    return expanded
