"""Where one query's wall time goes on the card: a torch.profiler trace of
``run_query`` on a warm engine, summed by device kernel.

  PYTHONPATH=src python -m repro_torch.launch.profile_query --query q12 \\
      [--sf 1] [--target-mb 64] [--trace chiprun_out/q12_trace.json]

Prints one JSON line: the query's wall seconds (host clock, ending in
``torch.cuda.synchronize()``), the device-busy seconds (the union of
kernel intervals on the card), the idle share 1 - busy / wall, and the
ten kernels with the most device time (names cut to 80 characters),
with the device time of the partition_pack kernels (``pp_*``, the
template ``pp_place`` included) beside them. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.engine import make_engine, run_query
from repro_torch.relational.tpch import QUERIES


def busy_s(events) -> float:
    """Union of the device-kernel intervals (overlaps counted once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6                                   # us -> s


def device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, count) of each kernel and copy that ran on the
    card, most device time first; host-side operators are left out."""
    return sorted(((e.key, e.self_device_time_total * 1e-3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])


def is_kernel(key: str, prefix: str) -> bool:
    """Whether a profiler key names a kernel whose function name starts
    with ``prefix``; template kernels are keyed "void name<T>(...)"."""
    return re.search(rf"(^|\s){prefix}\w*[<(]", key) is not None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="q12", choices=sorted(QUERIES))
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--target-mb", type=int, default=64)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_query needs a CUDA device")
    coord, _ = make_engine(sf=args.sf, seed=args.seed, device="cuda",
                           target_bytes=args.target_mb << 20,
                           compute_scale=1.0, executor_workers=1)
    run_query(coord, args.query)                        # warm-up run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_query(coord, args.query)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_s(prof.events())
    kernels = device_kernels(prof)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "query": args.query, "sf": args.sf, "wall_s": wall,
        "device_busy_s": busy, "idle_share": 1 - busy / wall,
        "latency_s": res.latency_s, "attribution": res.attribution,
        "partition_pack_ms": sum(ms for k, ms, _ in kernels
                                 if is_kernel(k, "pp_")),
        "top_kernels_ms": [{"name": k[:80], "ms": ms, "count": n}
                           for k, ms, n in kernels[:10]]}))


if __name__ == "__main__":
    main()
