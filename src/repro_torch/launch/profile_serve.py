"""Where a serve cell's wall time goes on the card: torch.profiler traces
of one prefill and of a few decode steps of a cell ``launch/serve``
defines (``CELLS``: 4 prompts of 512 tokens at full width, weights and
prompts, and whisper's frames, from ``random_request``), after a warm-up.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
      [--arch mamba2-2.7b|glm4-9b|deepseek-v2-lite-16b|recurrentgemma-9b|
              whisper-tiny|llama4-maverick-400b-a17b] \\
      [--trace serve_trace.json]

Prints one JSON line per part (prefill, decode): wall seconds (host clock,
ending in ``torch.cuda.synchronize()``), device-busy seconds (the union of
kernel intervals on the card), the idle share 1 - busy / wall, the
kernels launched, the device time and CUDA launches of the port's kernels
on the serve path (ssd_scan: its four CUDA kernels ssd_cb,
ssd_chunk_state, ssd_state_pass and ssd_chunk_scan a call; flash_gqa: one
a call, two for a call with no mask and at most 16 query rows, whose split
body is flash_gqa_split and flash_gqa_merge; partition_pack, the MoE dispatch: three a call at B·E = 256 or
512 partitions, its multi-pass route; moe_combine, the MoE combine: one a
call) and the ten kernels with the most
device time. The weights are cast to bf16 in place (``cast_params_``),
so the card holds one copy. Runs on CUDA only.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.launch.profile_query import (busy_s, device_kernels,
                                              is_kernel)
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import build_model, cast_params_
from repro_torch.models.modules import init_params

DECODE_STEPS = 8                                        # traced decode steps
# the port's kernels on the serve path, by the prefix of their CUDA functions
KERNELS = {"ssd_scan": "ssd_", "flash_gqa": "flash_gqa_",
           "partition_pack": "pp_", "moe_combine": "moe_combine"}


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
    rec = {"part": name, "wall_s": wall, "device_busy_s": busy,
           "idle_share": 1 - busy / wall,
           "kernel_launches": sum(n for k, _, n in kernels
                                  if not k.startswith(("Memcpy", "Memset")))}
    for label, fn_name in KERNELS.items():
        mine = [(ms, n) for k, ms, n in kernels if is_kernel(k, fn_name)]
        rec[f"{label}_ms"] = sum(ms for ms, _ in mine)
        rec[f"{label}_launches"] = sum(n for _, n in mine)
    rec["top_kernels_ms"] = [{"name": k[:80], "ms": ms, "count": n}
                             for k, ms, n in kernels[:10]]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b",
                    choices=sorted(serve.CELLS))
    ap.add_argument("--trace", default=None,
                    help="write Chrome traces of both parts here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda")
    cell = serve.CELLS[args.arch]
    cfg = cell.config()
    bundle = build_model(cfg)
    params, tokens, frames = serve.random_request(cfg, cell.batch,
                                                  cell.prompt, cell.seed, dev)
    params, tokens = cast_params_(cfg, params), tokens.to(dev)
    prefill, decode = make_prefill_step(bundle), make_decode_step(bundle)
    batch = serve.prefill_batch(bundle, tokens, frames)

    def run_decode(steps):
        """``steps`` steps of the reference's loop from a fresh cache of
        the cell's size (a step's work does not depend on its position:
        decode attends over the whole cache, masked)."""
        serve.decode_loop(decode, params, init_params(
            bundle.cache_defs(cell.batch, cell.prompt + cell.new), None,
            dev), tokens[:, :1], steps, batch.get("frames"))

    prefill(params, batch)                              # warm-up
    run_decode(2)
    torch.cuda.synchronize()
    for name, fn in (("prefill", lambda: prefill(params, batch)),
                     ("decode", lambda: run_decode(DECODE_STEPS))):
        rec = _profiled(name, fn, args.trace)
        rec.update(arch=cfg.name, batch=cell.batch, prompt_len=cell.prompt,
                   steps=1 if name == "prefill" else DECODE_STEPS)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
