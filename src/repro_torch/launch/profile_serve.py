"""Where the serve cell's wall time goes on the card: torch.profiler traces
of one prefill and of a few decode steps of the cell ``launch/serve``
defines (``CELL_*``: mamba2-2.7b, 4 prompts of 512 tokens, weights and
prompts from ``random_request``), after a warm-up.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      [--trace serve_trace.json]

Prints one JSON line per part (prefill, decode): wall seconds (host clock,
ending in ``torch.cuda.synchronize()``), device-busy seconds (the union of
kernel intervals on the card), the idle share 1 - busy / wall, the
kernels launched, the device time of the ssd_scan kernel and the ten
kernels with the most device time. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.launch.profile_query import (busy_s, device_kernels,
                                              is_kernel)
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import build_model, cast_params
from repro_torch.models.modules import init_params

DECODE_STEPS = 8                                        # traced decode steps


def _profiled(name: str, fn, trace: str | None) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_s(prof.events())
    kernels = device_kernels(prof)
    if trace:
        prof.export_chrome_trace(trace.replace(".json", f"_{name}.json"))
    return {"part": name, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall,
            "kernel_launches": sum(n for k, _, n in kernels
                                   if not k.startswith(("Memcpy", "Memset"))),
            "ssd_scan_ms": sum(ms for k, ms, _ in kernels
                               if is_kernel(k, "ssd_chunk_scan")),
            "top_kernels_ms": [{"name": k[:80], "ms": ms, "count": n}
                               for k, ms, n in kernels[:10]]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="write Chrome traces of both parts here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config(serve.CELL_ARCH)
    bundle = build_model(cfg)
    params, tokens = serve.random_request(cfg, serve.CELL_BATCH,
                                          serve.CELL_PROMPT, serve.CELL_SEED,
                                          dev)
    params, tokens = cast_params(cfg, params), tokens.to(dev)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)

    def run_decode(steps):
        """``steps`` steps of the reference's loop from a fresh cache."""
        serve.decode_loop(decode, params, init_params(
            bundle.cache_defs(serve.CELL_BATCH, steps + 1), None, dev),
            tokens[:, :1], steps)

    prefill(params, {"tokens": tokens})                 # warm-up
    run_decode(2)
    torch.cuda.synchronize()
    for name, fn in (("prefill", lambda: prefill(params, {"tokens": tokens})),
                     ("decode", lambda: run_decode(DECODE_STEPS))):
        rec = _profiled(name, fn, args.trace)
        rec.update(arch=cfg.name, batch=serve.CELL_BATCH,
                   prompt_len=serve.CELL_PROMPT,
                   steps=1 if name == "prefill" else DECODE_STEPS)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
