"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from src/ (set-up);
  3. set-up of the engine: TPC-H SF 1 (seed 7) in 64 MiB base objects;
  4. kernel phase: partition_pack (CUDA) against its plain PyTorch version
     on the card, exactly (atol 0 on buf, counts and slots), at the Pallas
     kernel test's shapes and at the main path's (rows of the largest
     lineitem split, q12 scan_li's int64 and int32 column groups, 8 / 64 /
     1024 partitions), with kernel, plain and library times and the
     memory bound;
  5. query phase: q1, q3, q5, q6, q12, q12 (multi-stage shuffle) and q14
     through the port's engine on the card, each held against the
     single-threaded oracle run on the CPU through the plain versions;
     partition_pack must have launched in q3, q5, q12 and q14;
  6. structural parity: q3 and q12 at compute_scale=0 on cuda and on cpu
     give identical latency, cost, GETs, PUTs and task counts.
It then prints the kernels line and, last, the device line. Any failure
exits non-zero before the last line; without a card it exits 2 at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.engine import make_engine, oracle, run_query  # noqa
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as K  # noqa
from repro_torch.kernels.partition_pack import ref as pp_ref  # noqa: E402
from repro_torch.relational import ops as OPS  # noqa: E402
from repro_torch.relational.table import DictColumn, decode_object  # noqa

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
SF, SEED, TARGET_BYTES = 1.0, 7, 64 << 20
PALLAS_TEST_SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
                      (1024, 64, 24, 256)]
MAIN_PARTS = (8, 64, 1024)
Q12_SCAN_LI = ["l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
               "l_receiptdate"]
MULTI = {"shuffle": {"strategy": "multi", "p": 1 / 4, "f": 1 / 4}}
QUERIES = [("q1", {}), ("q3", {}), ("q5", {}), ("q6", {}), ("q12", {}),
           ("q12", MULTI), ("q14", {})]
MUST_PACK = {"q3", "q5", "q12", "q14"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def phase(name: str, t0: float):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


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


# ------------------------------------------------------------------ kernel
def pack_case(label: str, groups: list[torch.Tensor], ids: torch.Tensor,
              n_parts: int, capacity: int) -> dict:
    """Kernel vs plain on the card, exactly; times and the memory bound."""
    before = K.launches
    bufs, counts, slots = K.pack(groups, ids, n_parts, capacity)
    torch.cuda.synchronize()
    err = 0.0
    for g, buf in zip(groups, bufs):
        want, want_counts, want_slots, _ = pp_ref.pack(g, ids, n_parts,
                                                       capacity)
        check(torch.equal(counts, want_counts), f"{label}: counts differ")
        check(torch.equal(slots, want_slots), f"{label}: slots differ")
        check(torch.equal(buf, want), f"{label}: buf differs")
        err = max(err, float((buf.double() - want.double()).abs().max())
                  if buf.numel() else 0.0)

    def plain():
        slot, _, keep = pp_ref.pack_indices(ids, n_parts, capacity)
        for g in groups:
            pp_ref.pack_rows(g, ids, slot, keep, n_parts, capacity)

    def library():
        order = torch.sort(ids, stable=True).indices
        for g in groups:
            g.index_select(0, order)

    T = ids.shape[0]
    row_bytes = sum(g.shape[1] * g.element_size() for g in groups)
    moved = (4 * T + T * row_bytes                      # ids, rows read
             + 4 * T + 4 * n_parts                       # slots, counts
             + n_parts * capacity * row_bytes)           # buf written
    rec = {"case": label, "T": T, "n_parts": n_parts, "capacity": capacity,
           "groups": [f"{g.dtype}x{g.shape[1]}" for g in groups],
           "kernel_ms": time_ms(lambda: K.pack(groups, ids, n_parts,
                                               capacity)),
           "plain_ms": time_ms(plain), "library_ms": time_ms(library),
           "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err}
    rec["launches"] = K.launches - before          # 1 compared + 21 timed
    print("[kernel] " + json.dumps(rec), flush=True)
    return rec


def kernel_phase(tables, split_rows: int, dev) -> list[dict]:
    """-> every case's record, the main path's own shape (8 partitions)
    first."""
    recs = []
    for T, P, C, d in PALLAS_TEST_SHAPES:
        rng = np.random.default_rng(T + P)
        rows = torch.from_numpy(rng.standard_normal((T, d))
                                .astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)) \
            .to(dev)
        for dt in (torch.float32, torch.bfloat16):
            recs.append(pack_case(f"pallas-test {T}x{d} P={P} C={C} {dt}",
                                  [rows.to(dt)], ids, P, C))
    li = tables["lineitem"].project(Q12_SCAN_LI) \
        .take(torch.arange(split_rows)).to(dev)
    (n8, n4), views = OPS.width_groups(li)
    groups = [torch.stack([views[c] for c in g], 1) for g in (n8, n4)]
    main = []
    for n in MAIN_PARTS:
        ids = OPS.partition_ids(li["l_orderkey"], n)
        cap = int(torch.bincount(ids, minlength=n).max())
        main.append(pack_case(f"main q12 scan_li T={split_rows} P={n}",
                              groups, ids, n, cap))
    return main + recs


# ------------------------------------------------------------------- query
def _canon(t) -> dict:
    cols = {}
    for n in sorted(t.column_names()):
        c = t[n]
        c = c.codes if isinstance(c, DictColumn) else c
        cols[n] = c.cpu().numpy().astype(np.float64)
    if not cols:
        return cols
    order = np.lexsort(tuple(cols.values()))
    return {n: v[order] for n, v in cols.items()}


def same_result(got, want, what: str):
    g, w = _canon(got), _canon(want)
    check(sorted(g) == sorted(w), f"{what}: columns {sorted(g)} vs "
          f"{sorted(w)}")
    for n in w:
        check(g[n].shape == w[n].shape, f"{what}:{n}: shape {g[n].shape} "
              f"vs {w[n].shape}")
        check(bool(np.isfinite(g[n]).all()), f"{what}:{n}: not finite")
        check(np.allclose(g[n], w[n], rtol=1e-9, atol=1e-6),
              f"{what}:{n}: differs from the oracle")


def query_phase(coord, tables) -> int:
    expected = {}
    K.launches = 0                               # the main path's count
    for q, kw in QUERIES:
        before = K.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_query(coord, q, None, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = K.launches - before
        if q not in expected:
            expected[q] = oracle(q, tables)      # CPU, plain versions
        same_result(res.result, expected[q], q)
        print("[query] " + json.dumps({
            "query": q + ("-multi" if kw else ""),
            "latency_s": res.latency_s, "wall_s": wall,
            "cost": res.cost.total, "tasks": res.task_count,
            "gets": res.cost.gets, "puts": res.cost.puts,
            "partition_pack_launches": delta,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "attribution": res.attribution}),
            flush=True)
        if q in MUST_PACK:
            check(delta > 0, f"{q}: partition_pack never launched")
    return K.launches


def parity_phase():
    runs = {}
    for dev in ("cuda", "cpu"):
        coord, _ = make_engine(sf=SF, seed=SEED, device=dev,
                               target_bytes=TARGET_BYTES, compute_scale=0.0,
                               executor_workers=1)
        runs[dev] = [run_query(coord, q) for q in ("q3", "q12")]
    for q, a, b in zip(("q3", "q12"), runs["cuda"], runs["cpu"]):
        got = (a.latency_s, a.cost.total, a.cost.gets, a.cost.puts,
               a.task_count)
        want = (b.latency_s, b.cost.total, b.cost.gets, b.cost.puts,
                b.task_count)
        print(f"[parity] {q} cuda {got} cpu {want}", flush=True)
        check(got == want, f"{q}: cuda and cpu runs differ structurally")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase("card", t0)

    t0 = time.perf_counter()
    built = _build.build()
    for name in built:
        print(f"[build] {name}\n{_build.build_log(name)}", flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    coord, tables = make_engine(sf=SF, seed=SEED, device="cuda",
                                target_bytes=TARGET_BYTES, compute_scale=1.0,
                                executor_workers=1)
    splits = coord.base_splits["lineitem"]
    split_rows = max(len(decode_object(coord.store.get(k), ["l_orderkey"]))
                     for k in splits)
    print(f"[setup] lineitem {len(tables['lineitem'])} rows in "
          f"{len(splits)} splits, largest {split_rows} rows", flush=True)
    phase("engine set-up", t0)

    t0 = time.perf_counter()
    recs = kernel_phase(tables, split_rows, dev)
    main_rec = recs[0]
    phase("kernel", t0)

    t0 = time.perf_counter()
    launches = query_phase(coord, tables)
    phase("query", t0)

    t0 = time.perf_counter()
    parity_phase()
    phase("parity", t0)

    print(json.dumps({"kernels": [{
        "name": "partition_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/partition_pack/csrc/"
                  "partition_pack.cu",
        "replaces": "src/repro/kernels/partition_pack/partition_pack.py:83",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": "bytes",
        "library_ms": main_rec["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
