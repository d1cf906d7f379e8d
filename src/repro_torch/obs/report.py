"""Fleet and workload rollups: who ran what, how slow, and on whose dime.

``FleetResult.report()`` / ``WorkloadResult.report()`` build a
:class:`Report` — per-tenant and per-query-class aggregations of the flat
record list (reusing ``workload.driver.summarize`` so every number here
matches the gated workload summaries), renderable as aligned text for a
terminal or JSON for dashboards. A
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot can ride along, so
one artifact carries both the outcome rollup and the request-level
sketches.
"""
from __future__ import annotations

import dataclasses
import json
import math


def _class_rollup(records, makespan_s: float) -> dict:
    """Per-query-class summarize() over the records (class = query name)."""
    from repro_torch.workload.driver import summarize
    by_name: dict[str, list] = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    return {name: summarize(rs, makespan_s)
            for name, rs in sorted(by_name.items())}


@dataclasses.dataclass(frozen=True)
class Report:
    """A rendered-on-demand rollup. ``data`` is plain JSON-serializable
    dicts; ``to_text`` is the human view, ``to_json`` the machine one."""
    data: dict

    def to_json(self, path: str | None = None) -> str:
        s = json.dumps(self.data, indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    # ------------------------------------------------------------ text
    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return "-" if math.isnan(v) else f"{v:.4g}"
        return str(v)

    @classmethod
    def _table(cls, title: str, cols: list[str], rows: list[list],
               truncated: int = 0) -> list[str]:
        cells = [[cls._fmt(c) for c in row] for row in rows]
        widths = [max([len(h)] + [len(r[i]) for r in cells])
                  for i, h in enumerate(cols)]
        out = [title,
               "  ".join(h.ljust(w) for h, w in zip(cols, widths))]
        out += ["  ".join(c.ljust(w) for c, w in zip(row, widths))
                for row in cells]
        if truncated:
            out.append(f"... {truncated} more rows (see to_json())")
        return out

    def to_text(self, max_rows: int = 20) -> str:
        d = self.data
        s = d["summary"]
        lines = [f"{d['kind']} report"
                 + (f" (mode={d['mode']})" if "mode" in d else "")
                 + f": {s['queries']} queries, "
                 f"makespan {s['makespan_s']:.1f}s, "
                 f"${s['total_cost']:.4f}, "
                 f"{s['failed']} failed, {s['rejected']} rejected"]
        if "event_pops" in d:
            lines[0] += f", {d['event_pops']} event pops"
        tenants = d.get("tenants", {})
        if tenants:
            rows = sorted(tenants.items(),
                          key=lambda kv: -kv[1]["queries"])
            cut, rows = rows[max_rows:], rows[:max_rows]
            lines += self._table(
                "\nper tenant:",
                ["tenant", "queries", "failed", "rejected", "p50_s",
                 "p99_s", "$/query", "slot_s", "max_held"],
                [[name, t["queries"], t["failed"], t["rejected"],
                  t.get("latency_s_p50", math.nan),
                  t.get("latency_s_p99", math.nan),
                  t["cost_per_query"],
                  t.get("slot_seconds", 0.0),
                  t.get("quota_max_held", 0)] for name, t in rows],
                truncated=len(cut))
        classes = d.get("classes", {})
        if classes:
            lines += self._table(
                "\nper query class:",
                ["class", "queries", "p50_s", "p99_s", "$/query",
                 "cols_read"],
                [[name, c["queries"],
                  c.get("latency_s_p50", math.nan),
                  c.get("latency_s_p99", math.nan),
                  c["cost_per_query"],
                  c.get("columns_read_total", 0)]
                 for name, c in classes.items()])
        metrics = d.get("metrics", {})
        if metrics:
            rows = list(metrics.items())
            cut, rows = rows[max_rows:], rows[:max_rows]
            lines += self._table(
                "\nmetrics:", ["metric", "summary"],
                [[name, json.dumps(m)] for name, m in rows],
                truncated=len(cut))
        return "\n".join(lines)


def workload_report(wr, *, registry=None) -> Report:
    """Rollup of a ``WorkloadResult`` by query class."""
    data = {"kind": "workload", "summary": dict(wr.summary),
            "classes": _class_rollup(wr.records, wr.makespan_s)}
    if registry is not None:
        data["metrics"] = registry.collect()
    return Report(data)


def fleet_report(fr, *, registry=None) -> Report:
    """Rollup of a ``FleetResult``: per-tenant summaries enriched with
    quota high-water and billed slot-seconds, plus per-class rollups
    across the whole fleet."""
    tenants = {}
    for name, summ in fr.tenants.items():
        t = dict(summ)
        t["quota_max_held"] = fr.quota_max_held.get(name, 0)
        t["slot_seconds"] = fr.slot_seconds.get(name, 0.0)
        tenants[name] = t
    data = {"kind": "fleet", "mode": fr.mode,
            "summary": dict(fr.summary), "tenants": tenants,
            "classes": _class_rollup(fr.records, fr.makespan_s),
            "event_pops": fr.event_pops, "rejected": fr.rejected}
    if registry is not None:
        data["metrics"] = registry.collect()
    return Report(data)
