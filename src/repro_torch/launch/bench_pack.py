"""Time the partition_pack kernels at the shuffle producer's main shape on
the card: the rows of the largest lineitem split of TPC-H SF 1 (64 MiB
base objects, seed 7; 857,316 rows), q12 scan_li's columns as one int64
and one int32 group, partitioned by l_orderkey.

  PYTHONPATH=src python -m repro_torch.launch.bench_pack [--parts 8,64,1024]

For each partition count it prints one JSON line for each route of
``pack`` (look-back and multi-pass) and, at the first count, one for
``pack_by_key``: the mean time of a call by CUDA
events back to back (warm) and with L2 flushed before each call (cold),
the device time of its kernels by torch.profiler (warm and cold), each
kernel's share, the host's time to issue a call, the memory bound, and
``pp_place``'s phase clocks (median ns of each phase over the tiles).
Runs on CUDA only. ``chip_smoke.py`` reuses the timing helpers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings

import torch

from repro_torch.kernels.partition_pack import ops as pp_ops
from repro_torch.kernels.partition_pack import partition_pack as K
from repro_torch.relational import ops as OPS

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
FLUSH_BYTES = 80 << 20             # more than the H100's 50 MB L2
Q12_SCAN_LI = ["l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
               "l_receiptdate"]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up call (inputs stay in L2 where they fit)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flush_l2(scratch: torch.Tensor):
    scratch.fill_(1)


def time_cold_ms(fn, iters: int = 20) -> float:
    """Mean time of one call with L2 flushed before it: a write of
    FLUSH_BYTES runs before each call, outside the window its pair of CUDA
    events times."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush_l2(scratch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def is_pp(name: str) -> bool:
    """Whether a profiler name is one of partition_pack's kernels."""
    return name.split("(")[0].split("<")[0].split()[-1].startswith("pp_")


def device_ops(fn, cold: bool = False, iters: int = 1) -> list[tuple]:
    """(name, device ms) of each device operation (kernels, copies, fills)
    of ``iters`` calls of ``fn`` by torch.profiler, after a warm-up call;
    with ``cold``, L2 is flushed before each call, outside the trace's
    count (the flush's own kernel is left out)."""
    from torch.profiler import ProfilerActivity, profile
    scratch = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
               if cold else None)
    fn()
    torch.cuda.synchronize()
    ops = []
    for _ in range(iters):
        if cold:
            flush_l2(scratch)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops += [(e.name, (e.time_range.end - e.time_range.start) * 1e-3)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    return ops


def host_syncs(fn) -> int:
    """Host syncs of one call of ``fn``, by torch's sync debug mode."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def host_ms(fn, iters: int = 20) -> float:
    """Host seconds to issue one call (no sync inside the window), in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def pack_bytes(groups, T: int, n_parts: int, capacity: int) -> int:
    """Bytes ``pack`` must move (``partition_pack/ops.work``): ids and rows
    read once, slots, counts and buf written once."""
    row_bytes = sum(g.shape[1] * g.element_size() for g in groups)
    return pp_ops.work(T, row_bytes, n_parts, capacity)[1]


def profile_record(fn, iters: int = 10) -> dict:
    """Warm and cold device ms a call of ``fn`` (its kernels, by the
    profiler), per kernel, and the device operations of one call."""
    rec = {}
    for what, cold in (("warm", False), ("cold", True)):
        ops = device_ops(fn, cold=cold, iters=iters)
        per: dict[str, float] = {}
        for name, ms in ops:
            if is_kernel(name):
                short = name.split("(")[0].split()[-1]
                per[short] = per.get(short, 0.0) + ms / iters
        rec[f"device_{what}_ms"] = sum(per.values())
        rec[f"device_{what}_by_kernel_ms"] = per
    one = device_ops(fn)
    rec["device_ops"] = [n for n, _ in one]
    rec["cuda_kernels_per_call"] = sum(is_kernel(n) for n, _ in one)
    return rec


def phase_record(groups, ids, n: int, cap: int) -> dict:
    """pp_place's phase clocks of one warm call: the median over tiles of
    each phase's ns (``K.PHASES``), the spread of the tiles' starts, and
    the span from the first start to the last end."""
    T = ids.shape[0]
    clocks = torch.zeros((-(-T // K.TILE_ROWS), K.PHASE_CLOCKS),
                         dtype=torch.int64, device=ids.device)
    K.pack(groups, ids, n, cap)
    K.pack(groups, ids, n, cap, clocks=clocks)
    torch.cuda.synchronize()
    c = clocks.double()
    steps = (c[:, 1:] - c[:, :-1]).median(0).values.tolist()
    since = c - c[:, 0].min()
    q = torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64, device=c.device)
    return {"phase_median_ns": dict(zip(K.PHASES[1:], steps)),
            "slowest_ranked_tiles": since[:, 2].topk(
                min(6, since.shape[0])).indices.tolist(),
            "since_start_p50_p90_max_ns": {
                ph: since[:, i].quantile(q).tolist()
                for i, ph in enumerate(K.PHASES) if i >= 2},
            "start_spread_ns": float(c[:, 0].max() - c[:, 0].min()),
            "span_ns": float(c[:, -1].max() - c[:, 0].min()),
            "tile_ns_median": float((c[:, -1] - c[:, 0]).median())}


def main_split(sf: float = 1.0, seed: int = 7, target_mb: int = 64,
               device="cuda"):
    """(the largest lineitem split's q12 scan_li table on ``device``, its
    int64 and int32 column groups)."""
    from repro_torch.core.engine import make_engine
    from repro_torch.relational.table import decode_object
    coord, tables = make_engine(sf=sf, seed=seed, device=device,
                                target_bytes=target_mb << 20,
                                compute_scale=0.0, executor_workers=1)
    rows = max(len(decode_object(coord.store.get(k), ["l_orderkey"]))
               for k in coord.base_splits["lineitem"])
    li = tables["lineitem"].project(Q12_SCAN_LI).take(
        torch.arange(rows)).to(device)
    (n8, n4), views = OPS.width_groups(li)
    groups = [torch.stack([views[c] for c in g], 1) for g in (n8, n4)]
    return li, groups


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="8,64,256,1024")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_pack needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    li, groups = main_split()
    key = li["l_orderkey"]
    T = len(key)
    for i, n in enumerate(int(p) for p in args.parts.split(",")):
        ids = OPS.partition_ids(key, n)
        cap = int(torch.bincount(ids, minlength=n).max())
        nbytes = pack_bytes(groups, T, n, cap)

        def pack():
            K.pack(groups, ids, n, cap)

        routes = [("multi-pass", 0)]
        if n <= K.LOOKBACK_MAX_PARTS:
            routes.insert(0, ("look-back", K.LOOKBACK_MAX_PARTS))
        for route, limit in routes:
            saved, K.LOOKBACK_MAX_PARTS = K.LOOKBACK_MAX_PARTS, limit
            try:
                rec = {"entry": "pack", "route": route, "card": card,
                       "T": T, "n_parts": n, "capacity": cap,
                       "bytes": nbytes,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "event_warm_ms": time_ms(pack, args.iters),
                       "event_cold_ms": time_cold_ms(pack, args.iters),
                       "host_ms": host_ms(pack, args.iters),
                       **profile_record(pack),
                       **phase_record(groups, ids, n, cap)}
            finally:
                K.LOOKBACK_MAX_PARTS = saved
            print(json.dumps(rec), flush=True)
        if i:
            continue

        def by_key():
            K.pack_by_key(groups, key, n)

        rec = {"entry": "pack_by_key", "card": card, "T": T, "n_parts": n,
               "event_warm_ms": time_ms(by_key, args.iters),
               "event_cold_ms": time_cold_ms(by_key, args.iters),
               "host_ms": host_ms(by_key, args.iters),
               "host_syncs": host_syncs(by_key), **profile_record(by_key)}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
