"""One run of one cell: set-up, the measured window, the per-layer
readings (``--trace 1``), the output check, and the result line.

The pool is closed: it takes one batch at a time (``traffic.py``) and
dispatches the next as soon as the last batch's first tokens (the argmax
of the logits the prefill returns) are on the host. Every request of a
batch has that batch's time to first token. The KV cache each prefill
returns stays on the card, for the decode tier to take, until the
configuration's ``kv_handoff_tokens`` later prompt tokens have been
served (``Pool.handoff``).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import hashlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from harness import cell as C
from harness import check, faults, timing, traffic, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
POOL_ROWS = 256           # distinct batches of prompts drawn a run


@dataclasses.dataclass
class Rec:
    """One batch of the window, host seconds."""
    index: int
    seq: int
    rows: int
    dispatched: float
    enqueued: float        # the prefill call returned
    first: float           # its first tokens on the host
    served: torch.Tensor   # [rows] the first tokens (host)


@dataclasses.dataclass
class Run:
    """What a per-layer reader (``bench/metrics/<name>.py: read``) sees."""
    cell: dict
    mix: dict
    conf: dict
    structure: dict
    device: torch.device
    seed: int
    records: list
    window_s: float
    profile: dict | None = None

    def sub_seed(self, tag: str) -> int:
        return sub_seed(self.seed, tag)


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each thing a run draws (weights, prompts,
    the sample, a reader's inputs)."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


def parse(argv):
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Pool:
    """The system under test, the cell's weights and its prompts."""

    def __init__(self, root: Path, cell_name: str, seed: int, device,
                 fault: str | None = None, compute: str | None = None):
        """``fault`` (``faults.FAULTS``) breaks the step underneath;
        ``compute`` runs the program and draws the weights in another
        dtype than the configuration's (both for the output check's
        calibration only)."""
        from repro_torch.launch import serve, steps
        from repro_torch.models import model
        self.device = torch.device(device)
        self.bench = root / "bench"
        man = C.manifest(root)
        self.cell = C.entry(man["workloads"], cell_name, "workload")
        centry = C.entry(man["configs"], self.cell["config"], "config")
        self.conf = json.loads((root / centry["file"]).read_text())
        if compute:
            self.conf["compute_dtype"] = compute
            self.conf["program"]["replace"]["compute_dtype"] = compute
        self.mix = traffic.load(self.bench / "traffic"
                                / f"{self.cell['traffic']}.json")
        self.ref = C.reference(self.bench, self.conf["reference"])
        self.plain = importlib.import_module("_plain")
        self.structure = self.ref.structure(self.conf)
        self.cfg = C.program_config(self.conf)
        self.bundle = model.build_model(self.cfg)
        self.step = steps.make_prefill_step(self.bundle)
        if fault:
            self.step = faults.FAULTS[fault](self.step)
        self.prefill_batch = serve.prefill_batch
        n = self.conf["kv_handoff_tokens"] // self.mix["batch_tokens"]
        self.handoff = collections.deque(maxlen=n)
        self.draw(seed)

    def draw(self, seed: int):
        """Weights and prompts for ``seed`` (a new seed frees the old)."""
        self.params = self.flat = self.pool = None
        self.handoff.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.params, self.flat = weights.draw(
            self.bundle.param_defs, sub_seed(seed, "weights"), self.device,
            getattr(torch, self.conf["compute_dtype"]))
        self.pool = traffic.token_pool(self.mix, self.structure["vocab"],
                                       POOL_ROWS, sub_seed(seed, "prompts"),
                                       self.device)

    def prompts(self, i: int) -> torch.Tensor:
        b = traffic.batch_at(self.mix, i)
        return self.pool[i % POOL_ROWS, :b.rows * b.seq].view(b.rows, b.seq)

    def serve(self, i: int):
        """Batch i, dispatched and waited for. -> (Rec, logits)."""
        b = traffic.batch_at(self.mix, i)
        batch = self.prefill_batch(self.bundle, self.prompts(i))
        with torch.profiler.record_function("bench.prefill"):
            t0 = time.perf_counter()
            logits, cache = self.step(self.params, batch)
            t1 = time.perf_counter()
        with torch.profiler.record_function("bench.first_token"):
            served = logits[:, -1].argmax(-1).cpu()
            t2 = time.perf_counter()
        self.handoff.append(cache)   # the oldest one goes
        del cache
        return Rec(i, b.seq, b.rows, t0, t1, t2, served), logits

    def warm(self):
        """Every shape of the cycle once; then the handoff filled as the
        traffic before the window would have left it (caches of the
        cycle's shapes, the last one the cycle's last), so that the
        window starts in the steady state."""
        n = len(traffic.cycle(self.mix))
        for i in range(n):
            self.serve(i)
        shapes = list(self.handoff)[-n:]
        if shapes:
            self.handoff.clear()
            for j in range(self.handoff.maxlen):
                self.handoff.append(empty_like(
                    shapes[(j - self.handoff.maxlen) % len(shapes)]))
        sync(self.device)

    def window(self, seconds: float):
        """Batches from the cycle's start until ``seconds`` have passed;
        the window ends when the last batch's first tokens are back.
        -> (records, logits of each batch, window seconds)."""
        recs, held = [], []
        sync(self.device)
        w0 = time.perf_counter()
        i = 0
        while True:
            rec, logits = self.serve(i)
            recs.append(rec)
            held.append(logits)
            i += 1
            if rec.first - w0 >= seconds:
                break
        return recs, held, recs[-1].first - w0

    def sampled(self, recs, held, seed: int):
        """The requests to check, drawn from ``seed``, and what the pool
        gave them; ``held`` is emptied, and the card's cache freed.
        -> (their logits [n, V], the first tokens served [n], prompts)."""
        reqs = [(j, r, rec.seq) for j, rec in enumerate(recs)
                for r in range(rec.rows)]
        picked = check.sample(reqs, sub_seed(seed, "sample"))
        logits = torch.stack([held[j][r, -1].float() for j, r, _ in picked])
        served = torch.stack([recs[j].served[r] for j, r, _ in picked])
        prompts = [self.prompts(recs[j].index)[r].clone()
                   for j, r, _ in picked]
        del held[:]
        self.handoff.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return logits, served, prompts

    def reference(self, prompts, prec=None) -> torch.Tensor:
        """The reference's logits of ``prompts`` (float32 unless
        ``prec``), on this pool's weights."""
        return check.reference_logits(self.ref, self.flat, self.conf,
                                      prompts, prec or self.plain.Exact())

    def profiled(self, start: int) -> dict:
        """A short traced window, one turn of the cycle from batch
        ``start``: torch.profiler's records, the batches, the union of the
        card's busy intervals over the window's host span, and whether the
        records are whole (each batch's flash_gqa and partition_pack
        launches present)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n = len(traffic.cycle(self.mix))
        sync(self.device)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                batches = [self.serve(i)[0] for i in range(start, start + n)]
                sync(self.device)
        events = prof.events()
        win = [e for e in events if e.name == "bench.window"][0]
        lo, hi = win.time_range.start, win.time_range.end
        st = self.structure
        want_flash = n * sum(a["layers"] for a in st["attention"])
        want_pack = n * (st["moe"]["layers"] if st["moe"] else 0)
        got_flash = timing.count(events, "flash_gqa")
        got_pack = timing.count(events, "pp_")
        busy = timing.busy_s(events, lo, hi)
        return {"events": events, "batches": batches,
                "lo": lo, "hi": hi, "busy_s": busy,
                "window_s": (hi - lo) * 1e-6,
                "complete": busy > 0 and got_flash >= want_flash
                and got_pack >= want_pack,
                "flash_records": [got_flash, want_flash],
                "pack_records": [got_pack, want_pack]}


def empty_like(tree):
    """A cache of the same shapes (a dict of tensors, nested)."""
    if isinstance(tree, dict):
        return {k: empty_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(empty_like(v) for v in tree)
    return torch.empty_like(tree) if isinstance(tree, torch.Tensor) else tree


def end_to_end(recs, window_s: float) -> dict:
    """Prompt tokens a second over the window; the 95th percentile of
    time to first token over its requests."""
    tokens = sum(r.seq * r.rows for r in recs)
    ttft = [(r.first - r.dispatched) * 1e3 for r in recs
            for _ in range(r.rows)]
    return {"prefill_tokens_per_s": tokens / window_s,
            "ttft_p95_ms": statistics.quantiles(ttft, n=20,
                                                method="inclusive")[18]}


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules loaded in this process), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def main(argv=None, device=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    root = Path(args.root) if args.root else C.BENCH.parent
    man = C.manifest(root)
    cell = C.entry(man["workloads"], args.workload, "workload")
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)
    device = torch.device(device)
    sys.path.insert(0, str(root / "src"))
    t1 = time.perf_counter()
    pool = Pool(root, args.workload, args.seed, device)
    t2 = time.perf_counter()
    pool.warm()
    setup_s = time.perf_counter() - t0
    print(json.dumps({"setup_parts_s": {
        "start": t1 - t0, "build_and_draw": t2 - t1,
        "warm": setup_s - (t2 - t0)}}), file=sys.stderr)

    recs, held, window_s = pool.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    e2e = end_to_end(recs, window_s)
    print(json.dumps({"batches_ms": [  # length, in the call, to first tokens
        [r.seq, round((r.enqueued - r.dispatched) * 1e3, 3),
         round((r.first - r.dispatched) * 1e3, 3)] for r in recs]}),
        file=sys.stderr)
    e2e["setup_s"] = setup_s
    units = {m["name"]: m["unit"] for m in man["end_to_end"]
             + man["per_layer"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {}
    if args.trace:
        run = Run(cell, pool.mix, pool.conf, pool.structure, device,
                  args.seed, recs, window_s)
        run.profile = pool.profiled(len(recs))
        values = {}
        for m in man["per_layer"]:
            if C.applies(m, args.workload):
                v = C.metric_reader(pool.bench, m["name"]).read(run)
                if v is not None:
                    values[m["name"]] = v
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {
            "device_ops": timing.device_ops(run.profile["events"]),
            "idle_gaps": timing.idle_gaps(run.profile["events"],
                                          run.profile["lo"],
                                          run.profile["hi"])}
        print(json.dumps({"trace_records": {
            "flash_gqa": run.profile["flash_records"],
            "partition_pack": run.profile["pack_records"]}}),
            file=sys.stderr)
        run.profile = None
    else:
        values = {m["name"]: e2e[m["name"]] for m in man["end_to_end"]
                  if C.applies(m, args.workload)}
    if device.type == "cuda":
        dev["power"] = power_limit()

    logits, served, prompts = pool.sampled(recs, held, args.seed)
    ok, nums = check.judge(
        check.numbers(logits, served, pool.reference(prompts)),
        C.limits(pool.bench, args.workload))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, n in nums.items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    line = {"correct": ok,
            "attempted": sum(r.rows for r in recs),
            "failed": 0,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": dev, **result, "checks": nums}
    print(json.dumps(line), flush=True)
    return 0
