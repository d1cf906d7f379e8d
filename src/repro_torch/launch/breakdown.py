"""Per-operation breakdown of the roofline terms from a saved op record
(PyTorch port of ``repro.launch.breakdown``): which collectives and memory
operations contribute most. It reads the rows that ``launch/dryrun.py
--save-ops`` writes (``<cell>.ops.json``, the counterpart of the
reference's ``--save-hlo``); each row has its kind, its ATen operation,
its operands' shapes, its bytes and a short Python frame of the port's
model code in place of the HLO ``op_name``. Rows of one (kind, operation,
shapes, frame) are summed; the multiplier is how many there were (the
reference's loop multiplier).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.breakdown dryrun_out/<cell>.ops.json [coll|mem]
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

from repro_torch.launch.step_analysis import COLLECTIVES


def _summed(rows, keep) -> list[tuple]:
    agg: dict[tuple, list] = defaultdict(lambda: [0.0, 0])
    for r in rows:
        if keep(r):
            key = (r["kind"], r["op"], str(r["shapes"])[:60], r["frame"])
            agg[key][0] += r["bytes"]
            agg[key][1] += 1
    return sorted(((b, n, kind, shapes, f"{op} @ {frame}"[-80:])
                   for (kind, op, shapes, frame), (b, n) in agg.items()),
                  reverse=True)


def collective_breakdown(record: dict, top: int = 15) -> list[tuple]:
    """-> the ``top`` collectives by modeled per-device bytes: (bytes,
    count, kind, operand shapes, op @ frame)."""
    return _summed(record["ops"], lambda r: r["kind"] in COLLECTIVES)[:top]


def memory_breakdown(record: dict, top: int = 15,
                     min_bytes: float = 1e8) -> list[tuple]:
    """-> the ``top`` other operations by HBM bytes, each summed row over
    ``min_bytes``: (bytes, count, kind, operand shapes, op @ frame)."""
    rows = _summed(record["ops"], lambda r: r["kind"] not in COLLECTIVES)
    return [r for r in rows if r[0] > min_bytes][:top]


if __name__ == "__main__":
    path = sys.argv[1]
    kind = sys.argv[2] if len(sys.argv) > 2 else "coll"
    with open(path) as f:
        record = json.load(f)
    rows = collective_breakdown(record) if kind == "coll" \
        else memory_breakdown(record)
    for tot, m, k, t, op in rows:
        print(f"{tot / 1e9:8.2f}GB x{m:<6} {k:14s} {t:60s} {op}")
