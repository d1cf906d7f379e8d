"""flash_gqa's bodies timed on the card, in several source trees in turns
(say a parent commit and a change: parent, change, change, parent), so
that two versions of the kernel are compared inside one run.

For each tree (a directory holding ``src/repro_torch``), in the order
given, a child process imports that tree's package and times each of
``SHAPES`` in bf16 and f32: the kernel through ``flash_gqa.flash_gqa``
by CUDA events over ``--iters`` calls after a warm-up (what
``chip_smoke.py`` reports as kernel_ms; inputs stay in L2), its device
time a call by torch.profiler (one call a trace, ``--iters`` traces,
``bench_pack.device_ops``; each kernel's share too), and the same two
for the library yardstick (``scaled_dot_product_attention`` with
``enable_gqa``, the window as an explicit mask), with the bound of
``ops.work`` at the data sheet's peaks.
Where the tree's wrapper has the split body (``flash_gqa.body``), a shape
that takes it is timed in it and in the tiled body the shape would take
without it, which is how the split body's Sq limit was chosen. One JSON
line a (tree, shape, dtype, body).

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.bench_flash \\
      --trees <parent> <change> <change> <parent>
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (name, B, Sq, Skv, H, Hkv, D, causal, window): recurrentgemma-9b's
# prefill and its window at 4096 tokens; whisper-tiny's cross attention at
# a decode step (Sq 1) and at the prefill (Sq 64), and Sq around the split
# body's limit
SHAPES = (
    ("head_dim_256", 4, 512, 512, 16, 1, 256, True, 0),
    ("head_dim_256_window", 1, 4096, 4096, 16, 1, 256, True, 2048),
    ("cross_decode", 4, 1, 1500, 6, 6, 64, False, 0),
    ("cross_prefill", 4, 64, 1500, 6, 6, 64, False, 0),
    ("cross_sq2", 4, 2, 1500, 6, 6, 64, False, 0),
    ("cross_sq8", 4, 8, 1500, 6, 6, 64, False, 0),
    ("cross_sq16", 4, 16, 1500, 6, 6, 64, False, 0),
    ("cross_sq17", 4, 17, 1500, 6, 6, 64, False, 0),
    ("cross_sq32", 4, 32, 1500, 6, 6, 64, False, 0),
)
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}

_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np
import torch
from repro_torch.kernels.flash_gqa import flash_gqa as FK
from repro_torch.launch.bench_pack import device_ops
from repro_torch.kernels.flash_gqa import ops

tree, shapes, iters, bw = (sys.argv[1], json.loads(sys.argv[2]),
                           int(sys.argv[3]), float(sys.argv[4]))
peak = json.loads(sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def events_ms(fn):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn):
    per = {}
    for name, ms in device_ops(fn, iters=iters):
        key = name.removeprefix("void ").split("(")[0][:60]
        per[key] = per.get(key, 0.0) + ms / iters
    return sum(per.values()), per


for name, B, Sq, Skv, H, Hkv, D, causal, window in shapes:
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        rng = np.random.default_rng(Sq + Skv + D)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda().to(dt) for s in (
            (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
        kw = dict(causal=causal, window=window)
        bodies = [None]
        if hasattr(FK, "body"):
            which = FK.body(q.shape, v.shape, dt, **kw)
            bodies = [which] + (["tiled"] if which == "split" else [])
        flops, nbytes = ops.work(q.shape, k.shape, v.shape,
                                 elem_bytes=q.element_size(), **kw)
        mask = None
        if window:
            i = torch.arange(Sq, device="cuda")
            mask = ((i[None] <= i[:, None]) | (not causal)) \\
                & (i[None] > i[:, None] - window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and not window, enable_gqa=True)
        lib_ev = events_ms(library)
        lib_dev = device_ms(library)[0]
        for which in bodies:
            if which == "tiled":
                def kernel():
                    return FK._launch(q, k, v, kv_head=None, tiled=True, **kw)
            else:
                def kernel():
                    return FK.flash_gqa(q, k, v, **kw)
            want = library().transpose(1, 2).float()
            err = float((kernel().float() - want).abs().max())
            dev, names = device_ms(kernel)
            print(json.dumps({
                "tree": tree, "shape": name, "dtype": dtype,
                "body": which, "q": [B, Sq, H, D], "kv": [B, Skv, Hkv, D],
                "causal": causal, "window": window,
                "kernel_ms": events_ms(kernel), "kernel_device_ms": dev,
                "cuda_kernels": names, "library_ms": lib_ev,
                "library_device_ms": lib_dev,
                "bound_ms": max(flops / peak[dtype], nbytes / bw) * 1e3,
                "max_abs_err_vs_library": err}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_flash needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(smi, flush=True)
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, json.dumps(SHAPES),
             str(args.iters), str(HBM_BYTES_PER_S),
             json.dumps(PEAK)], capture_output=True, text=True, check=False)
        sys.stdout.write(res.stdout)
        if res.returncode:
            sys.stderr.write(res.stderr[-3000:])
            return res.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
