"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from src/ (set-up), and print
     each kernel function's registers, shared memory and spills from the
     ptxas report and its tensor-core instructions (HMMA, HGMMA) from
     cuobjdump's SASS;
  3. set-up of the engine: TPC-H SF 1 (seed 7) in 64 MiB base objects;
  4. kernel phase: partition_pack (CUDA) against its plain PyTorch version
     on the card, exactly (atol 0 on buf, counts and slots), at the Pallas
     kernel test's shapes, at the card tests' edges (1 to 8192 partitions,
     a hot key, T around a tile, capacity 0 and below the largest count,
     ids out of range, 2-, 4- and 8-byte groups in one call) and at the
     main path's (rows of the largest lineitem split, q12 scan_li's int64
     and int32 column groups, 8 / 64 / 1024 partitions), with kernel
     (warm), plain and library times and the memory bound; at the main
     shapes also the cold time (L2 flushed by an 80 MB write before each
     call, outside its events), the device time by torch.profiler (warm
     and cold) and the device operations of one call (two partition_pack
     kernels up to 64 partitions, three above: the multi-pass route); then
     pack_by_key (hash, counts and pack; one host sync) at 8 partitions
     against partition_ids and the plain pack, and op_partition's host
     syncs and device operations;
  5. query phase: q1, q3, q5, q6, q12, q12 (multi-stage shuffle) and q14
     through the port's engine on the card, each held against the
     single-threaded oracle run on the CPU through the plain versions;
     partition_pack must have launched in q3, q5, q12 and q14;
  6. structural parity: q3 and q12 at compute_scale=0 on cuda and on cpu
     give identical latency, cost, GETs, PUTs and task counts;
  6a. workload: the SF 1 engine behind Session.from_coordinator runs a
     24-query TPC-H mix (Poisson, virtual mean 5 s) through run_mix:
     p50/p99, $ per query, wall, the Fig-7 break-even; partition_pack
     must launch, no serve kernel may, every record finite;
  6b. workload parity: the same mix and an exact two-tenant fleet (a
     foreground quota, a background tenant under admission="reject") on
     cuda and on cpu at SF 0.05, compute_scale=0: equal exactly;
  6c. failover: q12 and q3 killed halfway on the SF 1 store at
     compute_scale=0: the replay passes the store's immutability audit,
     latency and cost equal a run with no kill, rows equal the oracle;
  6d. trace: q12 and q3 through Session(trace=True, metrics=True) equal
     the untraced run; the Chrome export round-trips;
  6e. planner: pareto_search for q12 over 6 configs on cuda and on cpu
     at SF 0.05: equal frontiers;
  7. ssd kernel phase: ssd_scan (CUDA) against its plain version
     (ssd_chunked) on the card at the Pallas kernel test's CASES, the
     smoke config's chunk, a sequence shorter than its chunk and the serve
     path's main shape, y and state within rtol = atol = 2e-4 in f32 (and,
     at the main shape in bf16, y within one bf16 step), with kernel,
     plain and bound times at the main shape (the bound at the f32 pipes'
     rate and, beside it, at the 3xTF32 rate the kernels compute at);
  8. serve phase: the serve cell of launch/serve (mamba2-2.7b at full
     width and depth, 64 layers, random weights and prompts from
     serve.random_request), 4 prompts of 512 tokens and 32 new tokens
     through launch/serve.generate after a short warm-up request:
     prefill s, decode ms a step, tokens/s, peak memory; ssd_scan must
     launch once a layer (64) in the prefill; every logit finite; the
     prompt replayed through decode gives the prefill's last logits, in
     bf16 as near to the f32 answer as the bf16 prefill is, and in f32
     (one prompt) within the reference test's 2e-3;
  9. serve parity phase: the same config at 4 layers, one 256-token
     prompt, prefill on the card (kernel) against prefill on the CPU
     (plain versions) on identical weights, in f32 (1e-3) and in bf16
     (5 % relative L2, the tolerance the CPU tests hold the port's bf16
     to against the reference);
 10. flash kernel phase: flash_gqa (CUDA) against its plain version
     (attention_ref over k/v gathered by the kv-head map) on the card at
     the Pallas kernel test's CASES, smollm-135m's padded-head map and the
     dense serve path's main shape (B=4, S=512, 32 q heads over 2 kv
     heads, D 128, causal), within 2e-5 in f32 and 2e-2 in bf16, with
     kernel, plain, library (scaled_dot_product_attention, timed as a
     yardstick only) and bound times at the main shape;
 10a. grad: a dense smoke layer's wq/wk/wv gradients through flash_gqa
     (one launch forward, none backward) against the CPU's, f32;
 11. dense serve phase, after the Mamba weights are released: the serve
     cell glm4-9b at full width and depth (40 layers, 9.4 B parameters)
     through launch/serve.generate, 4 prompts of 512 tokens and 32 new
     tokens, as in phase 8: flash_gqa must launch once a layer (40) in the
     prefill and 0 attention calls routed to the plain path; replay vs
     prefill in bf16 against the f32 answer and in f32 (one 128-token
     prompt) within 2e-3;
 12. dense parity phase: glm4-9b at 2 layers and full width, one
     128-token prompt, card prefill against CPU prefill in f32 (1e-3) and
     bf16 (5 % relative L2), and smollm-135m at full depth (30 layers, its
     9/3 heads padded to 16/4) the same way in f32, so that the padded
     kv-head map runs on the card at a real width.
Each path runs with every launch count set to 0 just before it and read
just after; each phase prints its seconds and its peak device memory. It
then prints the kernels line and, last, the device line. Any failure exits
non-zero before the last line; without a card it exits 2 at once.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.engine import make_engine, oracle, run_query  # noqa
from repro_torch.core.session import QuerySpec, Session  # noqa: E402
from repro_torch.faults.journal import Journal  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.flash_gqa.ref import attention_ref  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as K  # noqa
from repro_torch.kernels.partition_pack import ref as pp_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SK  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.bench_pack import (  # noqa: E402
    host_syncs, is_kernel, is_pp, pack_bytes, profile_record, time_cold_ms,
    time_ms)
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, tree_leaves, tree_map)
from repro_torch import planner as PL  # noqa: E402
from repro_torch import workload as WL  # noqa: E402
from repro_torch.obs.trace import from_chrome  # noqa: E402
from repro_torch.relational import ops as OPS  # noqa: E402
from repro_torch.relational.table import DictColumn, decode_object  # noqa

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12             # H100 SXM f32, no tensor cores (same)
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense (same)
TF32_FLOP_PER_S = 495e12           # H100 SXM TF32 tensor cores, dense (same)
SF, SEED, TARGET_BYTES = 1.0, 7, 64 << 20
PALLAS_TEST_SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
                      (1024, 64, 24, 256)]
MAIN_PARTS = (8, 64, 1024)
EDGE_PARTS = (1, 8, 64, 1024, 8192)
PP_TILE = K.TILE_ROWS
Q12_SCAN_LI = ["l_orderkey", "l_shipmode", "l_shipdate", "l_commitdate",
               "l_receiptdate"]
MULTI = {"shuffle": {"strategy": "multi", "p": 1 / 4, "f": 1 / 4}}
QUERIES = [("q1", {}), ("q3", {}), ("q5", {}), ("q6", {}), ("q12", {}),
           ("q12", MULTI), ("q14", {})]
MUST_PACK = {"q3", "q5", "q12", "q14"}
SSD_CASES = [                      # B, S, H, P, G, N, chunk
    (1, 128, 2, 32, 1, 32, 64), (2, 256, 4, 64, 2, 64, 128),
    (1, 256, 2, 64, 1, 128, 128), (2, 64, 2, 16, 1, 16, 32),  # Pallas test
    (2, 16, 8, 16, 1, 16, 8),                                 # smoke chunk
    (1, 24, 2, 16, 1, 16, 128)]                               # S < chunk
SSD_MAIN = (4, 512, 80, 64, 1, 128, 128)   # the serve phase's prefill
# bf16 keeps 8 significant bits. Prefill (chunked SSD, one GEMM over 2048
# rows) and decode (recurrence, one row at a time) round at other places in
# each of 64 layers, and through random layers the rounding grows with
# depth, for the bf16 prefill against the f32 one as much as for decode
# against prefill (PERF.md). So the bf16 replay is held against the f32
# prefill of the same weights and prompts: at most twice as far from it as
# the bf16 prefill is. A decode that computed something else would land at
# about 1.41 in relative L2 (two unrelated logit vectors of one norm).
SERVE_BF16_FACTOR = 2.0
# the same property in f32 at full depth, at the reference test's 2e-3
# (tests/test_serve_consistency.py), on one prompt of 256 tokens
SERVE_F32_PROMPT, SERVE_F32_TOL = 256, 2e-3
PARITY_LAYERS, PARITY_PROMPT, PARITY_TOL = 4, 256, 1e-3
# card vs CPU in bf16: each side rounds after its own ops (cuBLAS and the
# CPU's GEMMs block their sums differently), as the port and the reference
# do on the CPU, where 4 smoke layers put them 2-4 % apart in relative L2
# (tests/test_torch_mamba.py); held at the same 5 %
PARITY_BF16_TOL = 0.05


# flash_gqa: the Pallas kernel test's CASES (tests/test_kernel_flash_gqa.py),
# smollm-135m's padded-head map (9/3 heads padded to 16/4; padded q heads
# read kv head 0) and the dense serve path's prefill shape (glm4-9b)
SMOLLM_MAP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)
FLASH_CASES = [                    # B, S, H, Hkv, D, causal, window, map
    (1, 128, 2, 2, 64, True, 0, None), (2, 256, 4, 2, 64, True, 0, None),
    (1, 256, 3, 1, 128, True, 0, None), (2, 128, 2, 2, 32, True, 0, None),
    (1, 384, 2, 1, 64, True, 128, None), (1, 200, 2, 2, 64, True, 0, None),
    (2, 130, 16, 4, 64, True, 0, SMOLLM_MAP)]
FLASH_MAIN = (4, 512, 32, 2, 128, True, 0, None)
# f32: sums in another order; bf16: each side rounds its f32 output once
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DENSE_ARCH, SMOLLM_ARCH = "glm4-9b", "smollm-135m"
DENSE_F32_PROMPT = 128             # the f32 replay at full depth
DENSE_PARITY_LAYERS, DENSE_PARITY_PROMPT = 2, 128

# the workload phases: a TPC-H mix of 24 queries (weights of
# workload.TPCH_MIX) with Poisson arrivals at a virtual mean of 5 s, on the
# SF 1 engine of the query phase; the exact cuda-vs-cpu checks (mix, fleet,
# planner, trace) run at SMALL_SF, where the CPU side takes seconds
MIX_QUERIES, MIX_INTERARRIVAL_S = 24, 5.0
SMALL_SF = 0.05
FAILOVER_QUERIES = ("q12", "q3")      # the stages that aggregate floats
PLANNER_GRID = [{"join": nt} for nt in (2, 8, 32)]
GRAD_TOL = 1e-3                       # card vs CPU gradients, f32, of max


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def phase(name: str, t0: float):
    """The phase's seconds and peak device memory (then reset)."""
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s, peak "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    torch.cuda.reset_peak_memory_stats()


def zero_counts():
    K.launches = SK.launches = FK.launches = FK.routed = 0


def counts() -> dict:
    return {"partition_pack": K.launches, "ssd_scan": SK.launches,
            "flash_gqa": FK.launches}


def release():
    """Free what the phase before left to the collector and the caching
    allocator; -> the bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


# ------------------------------------------------------------------ kernel
def check_pack(label: str, groups: list[torch.Tensor], ids: torch.Tensor,
               n_parts: int, capacity: int) -> float:
    """Kernel vs plain on the card, exactly (atol 0 on buf, counts and
    slots): rows whose id lies in [0, n_parts) are ranked among themselves,
    the others get slot -1 and land nowhere. -> the largest |difference|."""
    bufs, counts, slots = K.pack(groups, ids, n_parts, capacity)
    torch.cuda.synchronize()
    wants, want_counts, want_slots = K.plain_pack(groups, ids, n_parts,
                                                  capacity)
    check(torch.equal(counts, want_counts), f"{label}: counts differ")
    check(torch.equal(slots, want_slots), f"{label}: slots differ")
    err = 0.0
    for buf, want in zip(bufs, wants):
        check(buf.shape == want.shape and torch.equal(buf, want),
              f"{label}: buf differs")
        err = max(err, float((buf.double() - want.double()).abs().max())
                  if buf.numel() else 0.0)
    return err


def pack_case(label: str, groups: list[torch.Tensor], ids: torch.Tensor,
              n_parts: int, capacity: int, main: bool = False) -> dict:
    """Kernel vs plain on the card, exactly; warm times and the memory
    bound, and at a main shape the cold time and the device operations of
    one call."""
    before = K.launches
    err = check_pack(label, groups, ids, n_parts, capacity)

    def plain():
        slot, _, keep = pp_ref.pack_indices(ids, n_parts, capacity)
        for g in groups:
            pp_ref.pack_rows(g, ids, slot, keep, n_parts, capacity)

    def library():
        order = torch.sort(ids, stable=True).indices
        for g in groups:
            g.index_select(0, order)

    def kernel():
        K.pack(groups, ids, n_parts, capacity)

    T = ids.shape[0]
    moved = pack_bytes(groups, T, n_parts, capacity)
    rec = {"case": label, "T": T, "n_parts": n_parts, "capacity": capacity,
           "groups": [f"{g.dtype}x{g.shape[1]}" for g in groups],
           "kernel_ms": time_ms(kernel),
           "plain_ms": time_ms(plain), "library_ms": time_ms(library),
           "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err}
    if main:
        rec.update(kernel_cold_ms=time_cold_ms(kernel),
                   **profile_record(kernel))
        rec["cold_share_of_bound"] = (rec["bound_ms"]
                                      / rec["device_cold_ms"])
        ops = rec["device_ops"]
        want = 2 if n_parts <= K.LOOKBACK_MAX_PARTS else 3
        check(len(ops) == want and all(map(is_pp, ops)),
              f"{label}: {len(ops)} device operations a call, want {want} "
              f"partition_pack kernels: {ops}")
    rec["launches"] = K.launches - before
    print("[kernel] " + json.dumps(rec), flush=True)
    return rec


def mixed_groups(T: int, seed: int, dev) -> list[torch.Tensor]:
    """bf16, int32 and int64 groups in one call, and an int32 group 4 bytes
    off its allocation's start (so it is copied in narrower vectors)."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.integers(0, 2 ** 31, T * 4 + 1)
                            .astype(np.int32)).to(dev)
    return [torch.from_numpy(rng.standard_normal((T, 3)).astype(np.float32))
            .to(torch.bfloat16).to(dev),
            torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (T, 5))
                             .astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (T, 2),
                                          dtype=np.int64)).to(dev),
            flat[1:].view(T, 4)]


def edge_cases(dev) -> float:
    """The card tests' edges of the redesign, exactly: every partition
    count (both routes), a hot key, T around a tile, capacity 0 and below
    the largest count, ids out of range. -> the largest |difference|."""
    err = 0.0

    def run(label, T, P, seed, ids=None, cap=None):
        nonlocal err
        rng = np.random.default_rng(seed)
        if ids is None:
            ids = rng.integers(0, P, T).astype(np.int32)
        ids = torch.from_numpy(ids).to(dev)
        top = int(torch.bincount(ids[(ids >= 0) & (ids < P)],
                                 minlength=P).max())
        cap = top if cap is None else cap(top)
        err = max(err, check_pack(f"edge {label} T={T} P={P} C={cap}",
                                  mixed_groups(T, seed, dev), ids, P, cap))

    for P in EDGE_PARTS:
        run("parts", 40_000, P, P)
    for P in (8, 64, 2048):
        run("hot key", 5 * PP_TILE + 17, P, 3,
            ids=np.full(5 * PP_TILE + 17, P - 1, np.int32))
        for T in (1, PP_TILE - 1, PP_TILE + 1, 3 * PP_TILE + 5):
            run("tile edge", T, P, T, cap=lambda top: top + 3)
    for P in (8, 64, 2048):
        run("capacity 0", 3 * PP_TILE + 100, P, P + 1, cap=lambda top: 0)
        run("capacity below", 3 * PP_TILE + 100, P, P + 1,
            cap=lambda top: max(top // 2, 1))
    for P in (8, 64, 1024):
        rng = np.random.default_rng(P + 2)
        T = 2 * PP_TILE + 33
        ids = rng.integers(0, P, T).astype(np.int32)
        bad = rng.random(T) < 0.1
        ids[bad] = rng.choice([-1, -7, P, P + 5, 2 ** 31 - 1], bad.sum())
        run("ids out of range", T, P, P + 2, ids=ids)
    print(f"[kernel] edge cases exact, max |difference| {err}", flush=True)
    return err


def by_key_case(li, groups, dev) -> dict:
    """pack_by_key at the main shape (P = 8): ids equal the plain
    partition_ids, counts their histogram, bufs the plain pack at capacity
    = the largest count; warm and cold times and device operations a call.
    Then op_partition on the split: its host syncs and device operations."""
    key = li["l_orderkey"]
    n = MAIN_PARTS[0]
    bufs, counts, ids = K.pack_by_key(groups, key, n)
    torch.cuda.synchronize()
    want_ids = OPS.partition_ids(key, n)
    check(torch.equal(ids, want_ids), "pack_by_key: ids differ")
    check(counts == torch.bincount(want_ids, minlength=n).tolist(),
          "pack_by_key: counts differ")
    for g, buf in zip(groups, bufs):
        want, _, _, _ = pp_ref.pack(g, want_ids, n, max(counts))
        check(torch.equal(buf, want), "pack_by_key: buf differs")

    def kernel():
        K.pack_by_key(groups, key, n)

    rec = {"case": f"pack_by_key q12 scan_li T={len(key)} P={n}",
           "kernel_ms": time_ms(kernel), "kernel_cold_ms": time_cold_ms(
               kernel), "host_syncs": host_syncs(kernel),
           **profile_record(kernel)}
    print("[kernel] " + json.dumps(rec), flush=True)
    kernels = [o for o in rec["device_ops"] if is_kernel(o)]
    check(rec["host_syncs"] == 1 and len(kernels) == 2
          and all(map(is_pp, kernels)),
          f"pack_by_key: {rec['host_syncs']} syncs, device operations "
          f"{rec['device_ops']}")

    def partition():
        OPS.op_partition(li, "l_orderkey", n)

    ops = profile_record(partition, iters=1)["device_ops"]
    prec = {"op_partition": f"q12 scan_li T={len(key)} P={n}",
            "host_syncs": host_syncs(partition),
            "cuda_kernels": sum(map(is_kernel, ops)), "device_ops": ops,
            "pp_kernels": sum(map(is_pp, ops))}
    print("[op_partition] " + json.dumps(prec), flush=True)
    check(prec["host_syncs"] == 1, f"op_partition synced "
          f"{prec['host_syncs']} times, want 1")
    check(not any("elementwise" in o or "bincount" in o for o in ops),
          f"op_partition ran hash or count kernels outside the pack: {ops}")
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
    edge_err = edge_cases(dev)
    li = tables["lineitem"].project(Q12_SCAN_LI) \
        .take(torch.arange(split_rows)).to(dev)
    (n8, n4), views = OPS.width_groups(li)
    groups = [torch.stack([views[c] for c in g], 1) for g in (n8, n4)]
    main = []
    for n in MAIN_PARTS:
        ids = OPS.partition_ids(li["l_orderkey"], n)
        cap = int(torch.bincount(ids, minlength=n).max())
        main.append(pack_case(f"main q12 scan_li T={split_rows} P={n}",
                              groups, ids, n, cap, main=True))
    main[0]["by_key"] = by_key_case(li, groups, dev)
    main[0]["max_abs_err"] = max(main[0]["max_abs_err"], edge_err)
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
    return K.launches, expected


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


# ---------------------------------------------------------- workload phases
def finite(*xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def mix_args():
    return (WL.sample_mix(WL.TPCH_MIX, MIX_QUERIES, seed=SEED),
            WL.poisson(MIX_QUERIES, MIX_INTERARRIVAL_S, seed=SEED))


def workload_phase(coord) -> int:
    """The query phase's SF 1 engine behind Session.from_coordinator runs
    a 24-query TPC-H mix through run_mix: every shuffle producer on
    partition_pack, no serve kernel. -> partition_pack's launches."""
    zero_counts()                                # the workload path's count
    t0 = time.perf_counter()
    wl = Session.from_coordinator(coord).run_mix(*mix_args())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    fr = WL.frontier(wl.cost_per_query)
    summ = wl.summary
    print("[workload] " + json.dumps({
        "queries": summ["queries"], "sf": SF,
        "mean_interarrival_s": MIX_INTERARRIVAL_S,
        "latency_s_p50": summ["latency_s_p50"],
        "latency_s_p99": summ["latency_s_p99"],
        "queue_delay_s_p99": summ["queue_delay_s_p99"],
        "makespan_s": wl.makespan_s, "cost_per_query": wl.cost_per_query,
        "wall_s": wall, "partition_pack_launches": launched["partition_pack"],
        "break_even_threshold_s": fr.threshold_s,
        "break_even_s": fr.break_even_s}), flush=True)
    check(launched["partition_pack"] > 0,
          "partition_pack never launched on the workload path")
    check(launched["ssd_scan"] == launched["flash_gqa"] == 0,
          f"serve kernels launched on the workload path: {launched}")
    check(len(wl.records) == MIX_QUERIES and all(
        finite(r.arrival_s, r.queue_delay_s, r.latency_s, r.cost.total)
        and not r.failed for r in wl.records), "a workload record is not "
          "finite or failed")
    check(finite(fr.threshold_s), f"break-even threshold {fr.threshold_s}")
    return launched["partition_pack"]


def _record_sig(r) -> tuple:
    return (r.name, r.tenant, r.rejected, r.arrival_s, r.queue_delay_s,
            r.latency_s, r.cost.total, r.cost.gets, r.cost.puts,
            r.task_count, r.backup_count, r.columns_read)


def _fleet_streams():
    """fg: foreground under a slot quota; bg: background, rejected past
    one query in flight."""
    return [WL.TenantStream.open_loop(
                WL.TenantSpec("fg", slot_quota=16), WL.TPCH_MIX, 4,
                mean_interarrival_s=2.0, seed=1),
            WL.TenantStream.open_loop(
                WL.TenantSpec("bg", priority="background",
                              admission="reject", max_inflight=1),
                WL.TPCH_MIX, 4, mean_interarrival_s=0.5, seed=2)]


def small_session(dev: str, **kw) -> Session:
    return Session(sf=SMALL_SF, seed=SEED, compute_scale=0.0,
                   executor_workers=1, device=dev, **kw)


def workload_parity_phase():
    """run_mix and an exact two-tenant run_fleet on cuda and on cpu at
    compute_scale=0: records and fleet numbers equal exactly."""
    out = {}
    for dev in ("cuda", "cpu"):
        wl = small_session(dev).run_mix(*mix_args())
        fr = small_session(dev).run_fleet(_fleet_streams(), mode="exact")
        out[dev] = ([_record_sig(r) for r in wl.records], wl.summary,
                    [_record_sig(r) for r in fr.records], fr.tenants,
                    fr.quota_max_held, fr.rejected, fr.event_pops)
    got, want = out["cuda"], out["cpu"]
    print("[workload-parity] " + json.dumps({
        "sf": SMALL_SF, "mix_queries": len(got[0]),
        "mix_latency_s_p99": got[1]["latency_s_p99"],
        "fleet_queries": len(got[2]),
        "fg_latency_s_p99": got[3]["fg"]["latency_s_p99"],
        "bg_latency_s_p99": got[3]["bg"]["latency_s_p99"],
        "quota_max_held": got[4], "rejected": got[5],
        "event_pops": got[6], "equal": got == want}), flush=True)
    check(got == want, "cuda and cpu workload runs differ")
    check(got[5] > 0 and got[4]["fg"] <= 16,
          f"fleet admission or quota not exercised: {got[4]}, {got[5]}")


def failover_phase(coord, expected: dict):
    """run_with_failover of q12 and q3 on the card at compute_scale=0
    over the SF 1 store, killed halfway: the replay passes the store's
    immutability audit (every re-PUT byte-identical); latency, cost and
    journal frontier equal a run with no kill; the rows equal the
    oracle's."""
    c0 = Coordinator(coord.store, coord.base_splits, coord.policy,
                     seed=coord.seed, max_parallel=coord.max_parallel,
                     compute_scale=0.0, executor_workers=1,
                     device=coord.device)
    sess = Session.from_coordinator(c0)
    for q in FAILOVER_QUERIES:
        journal = Journal()
        whole = sess.spawn(journal).run_query(QuerySpec(q).build_plan())
        kill = journal.count // 2
        t0 = time.perf_counter()
        res, j = sess.run_with_failover(q, kill_after=kill)
        torch.cuda.synchronize()
        print("[failover] " + json.dumps({
            "query": q, "event_pops": journal.count, "kill_after": kill,
            "latency_s": res.latency_s, "cost": res.cost.total,
            "replay_wall_s": time.perf_counter() - t0,
            "checkpoints": len(j.entries)}), flush=True)
        check((res.latency_s, res.cost) == (whole.latency_s, whole.cost),
              f"{q}: failover latency or cost differs from the run with no "
              "kill")
        check(j.frontier == journal.frontier, f"{q}: journal frontier "
              "differs")
        same_result(res.result, expected[q], f"{q} failover")


def trace_phase():
    """q12 and q3 through Session(trace=True, metrics=True) on the card:
    results and latency equal the untraced run's; the Chrome export
    round-trips."""
    import tempfile
    traced = small_session("cuda", trace=True, metrics=True)
    plain = small_session("cuda")
    for q in FAILOVER_QUERIES:
        a, b = traced.submit(q), plain.submit(q)
        check((a.latency_s, a.cost, a.task_count)
              == (b.latency_s, b.cost, b.task_count),
              f"{q}: traced run differs from the untraced one")
        same_result(a.result, b.result, f"{q} traced")
    traced.tracer.finalize()
    traced.tracer.validate()
    spans = list(traced.tracer.spans())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        events = traced.tracer.to_chrome(str(path))
        rebuilt = [sp for r in from_chrome(json.loads(path.read_text()))
                   for sp in r.walk()]
    metrics = traced.metrics.registry.collect()
    print("[trace] " + json.dumps({
        "queries": list(FAILOVER_QUERIES), "spans": len(spans),
        "chrome_events": len(events), "metrics": len(metrics),
        "gets": metrics["gets"]["value"],
        "queries_seen": metrics["queries"]["value"]}), flush=True)
    check(len(rebuilt) == len(spans) > 0, "Chrome export lost spans")
    check(metrics["queries"]["value"] == len(FAILOVER_QUERIES),
          "metrics saw another number of queries")


def planner_phase():
    """pareto_search for q12 over a small grid on the card and on the CPU:
    equal frontiers (configs, predicted and simulated latency and
    cost)."""
    out = {}
    for dev in ("cuda", "cpu"):
        coord, _ = make_engine(sf=SMALL_SF, seed=SEED, compute_scale=0.0,
                               executor_workers=1, record_events=True,
                               device=dev)
        model, _ = PL.QueryModel.from_probe(coord, "q12", {"join": 8})
        ev = PL.QueryEvaluator(coord.store, coord.base_splits, "q12",
                               seed=SEED, max_parallel=coord.max_parallel,
                               executor_workers=1, device=dev)
        grid = [PL.PlanConfig.make(nt, parallel_reads=pr)
                for nt in PLANNER_GRID for pr in (8, 16)]
        sr = PL.pareto_search(model, ev, grid,
                              must_confirm=tuple(grid[::2]))
        out[dev] = [(p.config, p.pred_latency_s, p.pred_cost_usd,
                     p.sim_latency_s, p.sim_cost_usd) for p in sr.frontier]
        n_conf = sr.sim_evals
    print("[planner] " + json.dumps({
        "sf": SMALL_SF, "grid": len(PLANNER_GRID) * 2, "confirmed": n_conf,
        "frontier": [(dict(c.ntasks), c.parallel_reads, sl, sc)
                     for c, _, _, sl, sc in out["cuda"]],
        "equal": out["cuda"] == out["cpu"]}), flush=True)
    check(out["cuda"] == out["cpu"] and out["cuda"],
          "cuda and cpu planner frontiers differ")


def grad_phase(dev):
    """The gradients of a dense smoke layer's wq/wk/wv through flash_gqa
    on the card against the CPU's (plain versions), f32, within GRAD_TOL of
    each gradient's largest entry."""
    cfg = smoke_config("glm4-9b").replace(compute_dtype=torch.float32)
    x_np = np.random.default_rng(SEED).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32)
    cpu_params = init_params(TT.attn_defs(cfg),
                             torch.Generator().manual_seed(SEED), "cpu")
    grads, launched = {}, []
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d).requires_grad_(), cpu_params,
                     is_leaf=torch.is_tensor)
        x = torch.from_numpy(x_np).to(d)
        pos = torch.arange(x.shape[1], device=d)[None]
        launched.append(FK.launches)
        out, _ = TT.attn_apply(cfg, p, x, Sharder(), positions=pos)
        launched.append(FK.launches)
        gs = torch.autograd.grad(out.square().sum(),
                                 [p["wq"], p["wk"], p["wv"]])
        launched.append(FK.launches)
        grads[d.type] = [g.cpu() for g in gs]
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(grads["cuda"], grads["cpu"])]
    print("[grad] " + json.dumps({
        "layer": "glm4-9b smoke attention", "head_dim": cfg.head_dim,
        "rel_max_err_wq_wk_wv": errs,
        "flash_gqa_launches_forward_backward": [
            launched[1] - launched[0], launched[2] - launched[1]]}),
        flush=True)
    check(launched[1] - launched[0] == 1
          and launched[2] == launched[1] == launched[5],
          f"want one flash_gqa launch in the card's forward and none "
          f"elsewhere: {launched}")
    check(all(bool(torch.isfinite(g).all()) for g in grads["cuda"]),
          "card gradients not finite")
    check(max(errs) <= GRAD_TOL, f"card gradients differ from the CPU's: "
          f"{errs}")


# -------------------------------------------------------------- ssd kernel
def ssd_inputs(B, S, H, P, G, N, seed, dev, dtype=torch.float32):
    """x, dt (post-softplus), A, Bm, Cm from numpy, as the Pallas kernel
    test draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(x).to(dtype), t(dt), t(A), t(Bm).to(dtype), t(Cm).to(dtype))


def ssd_bound(B, S, H, P, G, N, chunk, elem_bytes):
    """(flops, bytes) the function needs: the causal triangle of C.B^T once
    per (b, group, chunk), as it does not depend on the head; per (b*h,
    chunk) the triangle of S.(x*dt), and C.state and B^T.(x*dt) in full;
    each input read once, each output written once, at model layout."""
    Q = min(chunk, S)
    tri = Q * (Q + 1) // 2
    flops = B * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * elem_bytes          # x read, y written
              + 4 * B * S * H + 4 * H                 # dt, A
              + 2 * B * S * G * N * elem_bytes        # Bm, Cm
              + 4 * B * H * P * N)                    # state written
    return flops, nbytes


def ssd_case(label, shape, dev, dtype=torch.float32, timed=False) -> dict:
    """Kernel vs plain on the card: y and state within rtol = atol = 2e-4
    in f32; in bf16 the state so too and y within one bf16 step (2^-7
    relative: each side rounds its own f32 sum once)."""
    B, S, H, P, G, N, chunk = shape
    args = ssd_inputs(B, S, H, P, G, N, S + P, dev, dtype)
    y, st = SK.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    y_r, st_r = ssd_chunked(*args, chunk)
    y_tol = (2e-4, 2e-4) if dtype == torch.float32 else (2 ** -7, 2e-4)
    for what, got, want, (rtol, atol) in (("y", y, y_r, y_tol),
                                          ("state", st, st_r, (2e-4, 2e-4))):
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{label}: {what} not finite")
        check(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
              f"{label}: {what} differs from the plain version by "
              f"{float((got - want).abs().max())}")
    rec = {"case": label, "shape": shape, "dtype": str(dtype),
           "max_abs_err_y": float((y.float() - y_r.float()).abs().max()),
           "max_abs_err_state": float((st - st_r).abs().max())}
    if timed:
        flops, nbytes = ssd_bound(*shape, y.element_size())
        rec.update(
            kernel_ms=time_ms(lambda: SK.ssd_scan(*args, chunk=chunk)),
            plain_ms=time_ms(lambda: ssd_chunked(*args, chunk)),
            flops=flops, bytes=nbytes,
            bound_ms=max(flops / F32_FLOP_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            # the same operations at the pipe the kernels use: 3xTF32,
            # three TF32 products for one f32 product
            bound_3xtf32_ms=max(3 * flops / TF32_FLOP_PER_S,
                                nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / F32_FLOP_PER_S
            >= nbytes / HBM_BYTES_PER_S else "bytes")
    print("[ssd] " + json.dumps(rec), flush=True)
    return rec


def ssd_phase(dev) -> tuple[dict, float]:
    """-> (the main shape's record in the serve path's bf16, the largest
    f32 error of any case)."""
    err = 0.0
    for shape in SSD_CASES:
        r = ssd_case(f"case {shape}", shape, dev)
        err = max(err, r["max_abs_err_y"], r["max_abs_err_state"])
    r = ssd_case(f"main {SSD_MAIN} f32", SSD_MAIN, dev, timed=True)
    err = max(err, r["max_abs_err_y"], r["max_abs_err_state"])
    main_rec = ssd_case(f"main {SSD_MAIN} bf16", SSD_MAIN, dev,
                        torch.bfloat16, timed=True)
    return main_rec, err


# ------------------------------------------------------------------- serve
def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def serve_phase(dev, arch: str, kernel: str, f32_prompt: int) -> int:
    """The serve cell of ``arch`` (launch/serve.CELLS) at full width and
    depth through launch/serve.generate; ``kernel`` must launch once a
    layer in the prefill and no other kernel at all. Then the
    serve-consistency property: the bf16 replay against the f32 answer,
    and in f32 on one prompt of ``f32_prompt`` tokens at the reference
    test's 2e-3. -> ``kernel``'s launches in the counted run."""
    cell = serve.CELLS[arch]
    cfg = get_config(cell.arch)
    B = cell.batch
    t0 = time.perf_counter()
    params, tokens = serve.random_request(cfg, B, cell.prompt, cell.seed,
                                          dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {sum(t.numel() for t in tree_leaves(params))} "
          f"parameters ({cfg.param_dtype}), compute {cfg.compute_dtype}; "
          f"init {time.perf_counter() - t0:.3f} s; allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    serve.generate(cfg, params, tokens[:, :128], 2, dev)   # warm-up request

    zero_counts()                                      # the serve path's count
    torch.cuda.reset_peak_memory_stats()
    out = serve.generate(cfg, params, tokens, cell.new, dev)
    launched = counts()
    launches = launched[kernel]
    max_mem = torch.cuda.max_memory_allocated()
    lp, lr = out.prefill_logits.float(), out.replay_logits.float()
    # the f32 answer on the same weights and prompts (after the count)
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    b32 = build_model(cfg32)
    l32, _ = make_prefill_step(b32)(params, serve.prefill_batch(
        b32, tokens.to(dev)))
    e_prefill, e_replay = rel_l2(lp, l32), rel_l2(lr, l32)
    rec = {"arch": cfg.name, "batch": B, "prompt": cell.prompt,
           "new_tokens": cell.new, "prefill_s": out.prefill_s,
           "decode_s": out.decode_s, "decode_steps": out.decode_steps,
           "decode_ms_per_step": out.decode_s / out.decode_steps * 1e3,
           "tokens_per_s": B * cell.new / (out.prefill_s + out.decode_s),
           "max_memory_allocated": max_mem, "launches": launched,
           "flash_gqa_routed": FK.routed,
           "replay_vs_prefill_rel_l2": rel_l2(lr, lp),
           "prefill_vs_f32_rel_l2": e_prefill,
           "replay_vs_f32_rel_l2": e_replay,
           "logit_scale_max_abs": float(l32.abs().max()),
           "tokens": out.tokens[0, :8].tolist()}
    print("[serve] " + json.dumps(rec), flush=True)
    check(launches == cfg.num_layers,
          f"{kernel} launched {launches} times in the prefill, want one a "
          f"layer ({cfg.num_layers})")
    check(sum(launched.values()) == launches,
          f"other kernels launched on the {arch} serve path: {launched}")
    check(FK.routed == 0, f"{FK.routed} attention calls routed to the "
          f"plain path on the {arch} serve path")
    check(tuple(lp.shape) == (B, 1, cfg.vocab_size),
          f"prefill logits of shape {tuple(lp.shape)}")
    check(bool(torch.isfinite(lp).all() and torch.isfinite(lr).all()
               and torch.isfinite(l32).all()), "serve logits not finite")
    check(tuple(out.tokens.shape) == (B, cell.new)
          and int(out.tokens.min()) >= 0
          and int(out.tokens.max()) < cfg.vocab_size,
          f"generated tokens {tuple(out.tokens.shape)} out of range")
    check(e_replay <= SERVE_BF16_FACTOR * e_prefill,
          f"bf16 decode replay {e_replay} from the f32 answer, more than "
          f"{SERVE_BF16_FACTOR} x the bf16 prefill's {e_prefill}")

    one = serve.generate(cfg32, params, tokens[:1, :f32_prompt], 1, dev)
    lp, lr = one.prefill_logits, one.replay_logits
    err = float((lr - lp).abs().max())
    print("[serve-f32] " + json.dumps({
        "arch": cfg.name, "prompt": f32_prompt,
        "replay_vs_prefill_max_abs": err,
        "replay_vs_prefill_rel_l2": rel_l2(lr, lp),
        "decode_ms_per_step": one.decode_s / one.decode_steps * 1e3}),
        flush=True)
    check(bool(((lr - lp).abs() <= SERVE_F32_TOL
                + SERVE_F32_TOL * lp.abs()).all()),
          f"f32 decode replay vs prefill differ by {err}")
    return launches


def prefill_parity(cfg, prompt: int, dev, kernel: str, dtypes):
    """Prefill on the card (``kernel`` once a layer) against prefill on the
    CPU (plain versions) on identical weights, drawn on the card and
    copied over: f32 within PARITY_TOL, bf16 within PARITY_BF16_TOL
    relative L2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, tokens = serve.random_request(cfg, 1, prompt, 0, dev)
    on_cpu = tree_map(lambda t: t.cpu(), params)
    for dtype in dtypes:
        bundle = build_model(cfg.replace(compute_dtype=dtype))
        step = make_prefill_step(bundle)
        before, routed = counts()[kernel], FK.routed
        got, _ = step(params, serve.prefill_batch(bundle, tokens.to(dev)))
        got = got.cpu().float()
        launched = counts()[kernel] - before
        routed = FK.routed - routed
        want, _ = step(on_cpu, serve.prefill_batch(bundle, tokens))
        want = want.float()
        err, rel = float((got - want).abs().max()), rel_l2(got, want)
        print("[parity-serve] " + json.dumps({
            "arch": cfg.name, "layers": cfg.num_layers, "prompt": prompt,
            "dtype": str(dtype), f"{kernel}_launches": launched,
            "flash_gqa_routed": routed,
            "max_abs_err": err, "rel_l2": rel,
            "logit_scale_max_abs": float(want.abs().max())}), flush=True)
        check(launched == cfg.num_layers and routed == 0,
              f"{cfg.name}: {kernel} launched {launched} times, "
              f"{routed} calls routed to the plain path")
        check(bool(torch.isfinite(got).all()), "card logits not finite")
        if dtype == torch.float32:
            check(bool(((got - want).abs() <= PARITY_TOL
                        + PARITY_TOL * want.abs()).all()),
                  f"{cfg.name}: card vs cpu f32 prefill logits differ by "
                  f"{err}")
        else:
            check(rel <= PARITY_BF16_TOL, f"{cfg.name}: card vs cpu bf16 "
                  f"prefill logits {rel} apart in relative L2")


# ------------------------------------------------------------ flash kernel
def flash_inputs(B, S, H, Hkv, D, seed, dev, dtype):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, H, D)),
            rng.standard_normal((B, S, Hkv, D)),
            rng.standard_normal((B, S, Hkv, D)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrs]


def flash_bound(B, S, H, Hkv, D, causal, window, elem_bytes):
    """(flops, bytes) the function needs: q.k and p.v, 2*D FLOP each, for
    every (query, key) pair the masks leave, per (b, h); q, k, v read once
    and o written once at model layout (k and v at kv-head layout)."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += (i + 1 if causal else S) - lo
    flops = 4 * D * pairs * B * H
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * elem_bytes + 4 * H
    return flops, nbytes


def flash_case(shape, dev, dtype, timed=False) -> dict:
    """Kernel vs plain on the card: |o - want| <= tol + tol * |want|, tol
    2e-5 in f32, 2e-2 in bf16 (the Pallas kernel test's)."""
    B, S, H, Hkv, D, causal, window, kv_head = shape
    q, k, v = flash_inputs(B, S, H, Hkv, D, S + H, dev, dtype)
    m = torch.tensor(kv_head if kv_head is not None
                     else [h // (H // Hkv) for h in range(H)], device=dev)

    def plain():
        return attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                             causal=causal, window=window)

    def kernel():
        return FK.flash_gqa(q, k, v, causal=causal, window=window,
                            kv_head=kv_head)

    o = kernel()
    torch.cuda.synchronize()
    want = plain()
    tol = FLASH_TOL[dtype]
    label = f"{shape[:7]} {'padded map' if kv_head else ''} {dtype}"
    err = float((o.float() - want.float()).abs().max())
    check(bool(torch.isfinite(o).all()), f"flash {label}: not finite")
    check(bool(((o.float() - want.float()).abs()
                <= tol + tol * want.float().abs()).all()),
          f"flash {label}: differs from the plain version by {err}")
    rec = {"case": label, "max_abs_err": err}
    if timed:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        check(lib_err <= tol + tol * float(want.float().abs().max()),
              f"flash {label}: the library yardstick computes something "
              f"else ({lib_err})")
        flops, nbytes = flash_bound(B, S, H, Hkv, D, causal, window,
                                    q.element_size())
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
        rec.update(kernel_ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), library_max_abs_err=lib_err,
                   flops=flops, bytes=nbytes,
                   bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
                   bound_by="operations" if flops / peak
                   >= nbytes / HBM_BYTES_PER_S else "bytes")
    print("[flash] " + json.dumps(rec), flush=True)
    return rec


def flash_phase(dev) -> tuple[dict, float]:
    """-> (the main shape's record in the serve path's bf16, the largest
    error of any case in either dtype)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version in
    torch.backends.cudnn.allow_tf32 = False           # full f32
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_CASES:
            err = max(err, flash_case(shape, dev, dtype)["max_abs_err"])
    err = max(err, flash_case(FLASH_MAIN, dev, torch.float32,
                              timed=True)["max_abs_err"])
    main_rec = flash_case(FLASH_MAIN, dev, torch.bfloat16, timed=True)
    return main_rec, max(err, main_rec["max_abs_err"])


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
    for name in built:
        tc = _build.tensor_core_ops(name) or {}
        for fn, res in sorted(_build.resources(name).items()):
            print("[resources] " + json.dumps({
                "kernel": name, "function": fn, **res,
                "tensor_core_instructions": tc.get(fn)}), flush=True)
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
    zero_counts()                                # the query path's count
    launches, expected = query_phase(coord, tables)
    check(FK.launches == SK.launches == 0,
          f"serve kernels launched on the query path: {counts()}")
    phase("query", t0)

    t0 = time.perf_counter()
    parity_phase()
    phase("parity", t0)

    t_new = t0 = time.perf_counter()
    wl_launches = workload_phase(coord)
    phase("workload", t0)

    t0 = time.perf_counter()
    workload_parity_phase()
    phase("workload-parity", t0)

    t0 = time.perf_counter()
    failover_phase(coord, expected)
    phase("failover", t0)

    t0 = time.perf_counter()
    trace_phase()
    phase("trace", t0)

    t0 = time.perf_counter()
    planner_phase()
    phase("planner", t0)
    print(f"[phase] new phases of this slice: "
          f"{time.perf_counter() - t_new:.3f} s", flush=True)

    t0 = time.perf_counter()
    ssd_rec, ssd_err = ssd_phase(dev)
    phase("ssd kernel", t0)

    t0 = time.perf_counter()
    ssd_launches = serve_phase(dev, "mamba2-2.7b", "ssd_scan",
                               SERVE_F32_PROMPT)
    phase("serve", t0)

    t0 = time.perf_counter()
    prefill_parity(get_config("mamba2-2.7b").replace(
        num_layers=PARITY_LAYERS), PARITY_PROMPT, dev, "ssd_scan",
        (torch.float32, torch.bfloat16))
    phase("serve parity", t0)

    t0 = time.perf_counter()
    flash_rec, flash_err = flash_phase(dev)
    phase("flash kernel", t0)

    t0 = time.perf_counter()
    grad_phase(dev)
    phase("grad", t0)

    t0 = time.perf_counter()
    print(f"[dense] allocated before the dense phases: {release()} bytes",
          flush=True)
    flash_launches = serve_phase(dev, DENSE_ARCH, "flash_gqa",
                                 DENSE_F32_PROMPT)
    phase("dense serve", t0)

    t0 = time.perf_counter()
    release()
    prefill_parity(get_config(DENSE_ARCH).replace(
        num_layers=DENSE_PARITY_LAYERS), DENSE_PARITY_PROMPT, dev,
        "flash_gqa", (torch.float32, torch.bfloat16))
    prefill_parity(get_config(SMOLLM_ARCH), DENSE_PARITY_PROMPT, dev,
                   "flash_gqa", (torch.float32,))
    phase("dense parity", t0)

    print(json.dumps({"kernels": [{
        "name": "partition_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/partition_pack/csrc/"
                  "partition_pack.cu",
        "replaces": "src/repro/kernels/partition_pack/partition_pack.py:83",
        "launches": launches + wl_launches,
        "launches_by_path": {"query": launches, "workload": wl_launches},
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["kernel_ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": "bytes",
        "library_ms": main_rec["library_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:65",
        "launches": ssd_launches, "max_abs_err": ssd_err,
        "ms": ssd_rec["kernel_ms"], "plain_ms": ssd_rec["plain_ms"],
        "bound_ms": ssd_rec["bound_ms"], "bound_by": ssd_rec["bound_by"],
        "library_ms": None}, {
        "name": "flash_gqa", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_gqa/csrc/flash_gqa.cu",
        "replaces": "src/repro/kernels/flash_gqa/flash_gqa.py:72",
        "launches": flash_launches, "max_abs_err": flash_err,
        "ms": flash_rec["kernel_ms"], "plain_ms": flash_rec["plain_ms"],
        "bound_ms": flash_rec["bound_ms"],
        "bound_by": flash_rec["bound_by"],
        "library_ms": flash_rec["library_ms"]}]}), flush=True)
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
