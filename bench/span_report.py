"""Where one traced turn of a cell goes, by the program's spans: one JSON
line of device milliseconds by innermost span (``harness/spans.py``), the
kernels with the most time under each, the idle gaps with the span open
at each, the host syncs inside ``model.prefill``, the attribution's checks
against kernel names, and the per-layer metrics of the turn.

  python3 bench/span_report.py --workload <cell> --seed <n> \
      [--root <checkout>] [--turns 1]

The pool is built and warmed as ``bench/run.py`` builds it (``--root``:
the program and benchmark files of another checkout); then ``--turns``
traced turns of the cycle, each reported. Runs on CUDA only.
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import cell as C  # noqa: E402
from harness import spans as SP  # noqa: E402
from harness import timing  # noqa: E402

SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")


def report(events, lo, hi) -> dict:
    att = SP.attribute(events)
    by = collections.defaultdict(float)
    top = collections.defaultdict(lambda: collections.defaultdict(float))
    for d, name in att:
        us = d.time_range.elapsed_us()
        by[name] += us
        top[name][d.name[:90]] += us
    in_prefill = sum(us for n, us in by.items() if n is not None)
    flash = [n for d, n in att if timing.named(d.name, "flash_gqa")]
    pack = [n for d, n in att if timing.named(d.name, "pp_")]
    inner = SP.Innermost(SP.ranges(events))
    pre = SP.ranges(events, SP.PREFILL)
    syncs = collections.Counter()
    for e in SP.inside(events, pre, lambda e: e.name.startswith(SYNC)):
        s = inner.at(e.thread, e.time_range.start)
        syncs[f"{e.name} in {s.name if s else None}"] += 1
    busy = timing.union([(d.time_range.start, d.time_range.end)
                         for d in timing.device_events(events)])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    host = timing.host_events(events)
    thread = pre[0].thread if pre else None
    out_gaps = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:12]:
        open_ = [e for e in host if e.time_range.start <= a < e.time_range.end]
        rec = min(open_, key=lambda e: e.time_range.elapsed_us()).name \
            if open_ else "host idle"
        s = inner.at(thread, a)
        out_gaps.append([rec[:60], s.name if s else None, (b - a) * 1e-3])
    bench_prefill = [e for e in host if e.name == "bench.prefill"]
    return {
        "device_ms_by_span": {str(k): v * 1e-3 for k, v in
                              sorted(by.items(), key=lambda r: -r[1])},
        "device_ms_in_spans": in_prefill * 1e-3,
        "attn_plus_ffn_share": sum(
            us for n, us in by.items() if SP.under(n, "model.attn")
            or SP.under(n, "model.ffn")) / in_prefill if in_prefill else None,
        "top_by_span": {str(k): sorted(([n, us * 1e-3] for n, us in
                                        v.items()), key=lambda r: -r[1])[:4]
                        for k, v in top.items()},
        "checks": {
            "flash_gqa_records": len(flash),
            "flash_gqa_not_under_attn": sum(
                not SP.under(n, "model.attn") for n in flash),
            "pp_records": len(pack),
            "pp_not_under_dispatch": sum(
                n != "model.ffn.dispatch" for n in pack),
            "unattributed_share_in_prefill": by.get(SP.PREFILL, 0.0)
            / in_prefill if in_prefill else None},
        "syncs_in_prefill": dict(syncs),
        "idle_gaps_ms": out_gaps,
        "prefill_host_ms": [s.time_range.elapsed_us() * 1e-3 for s in pre],
        "bench_prefill_host_ms": [e.time_range.elapsed_us() * 1e-3
                                  for e in bench_prefill],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from harness import main as M
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    pool = M.Pool(root, args.workload, args.seed, dev)
    pool.warm()
    man = C.manifest(HERE.parent)
    n = len(pool.mix["cycle"])
    for turn in range(args.turns):
        t0 = time.perf_counter()
        prof = pool.profiled(turn * n)
        run = M.Run(pool.cell, pool.mix, pool.conf, pool.structure, dev,
                    args.seed, prof["batches"], prof["window_s"], prof)
        metrics = {}
        for m in man["per_layer"]:
            if C.applies(m, args.workload):
                metrics[m["name"]] = C.metric_reader(HERE, m["name"]).read(
                    run)
        line = {"workload": args.workload, "root": str(root), "turn": turn,
                "power": M.power_limit(), "busy_s": prof["busy_s"],
                "window_s": prof["window_s"],
                "trace_records": [prof["flash_records"],
                                  prof["pack_records"]],
                "metrics": metrics,
                **report(prof["events"], prof["lo"], prof["hi"]),
                "report_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
