"""flash_gqa's bodies timed on the card, in several source trees in turns
(say a parent commit and a change: parent, change, change, parent), so
that two versions of the kernel are compared inside one run.

For each tree (a directory holding ``src/repro_torch``), in the order
given, a child process imports that tree's package and times each of
``SHAPES`` in bf16 and f32: the kernel through ``flash_gqa.flash_gqa``
by CUDA events over ``--iters`` calls after a warm-up (what
``chip_smoke.py`` reports as kernel_ms: at these sizes the host's time
to launch a call), its device time a call (``--iters`` calls captured in
a CUDA graph, the graph replayed ``GRAPH_REPLAYS`` times between two
CUDA events, so no host work lies between the calls; inputs stay in
L2), and the same two for the library yardstick
(``scaled_dot_product_attention`` with ``enable_gqa``, the window as an
explicit mask), with the bound of ``ops.work`` at the data sheet's peaks
and the CUDA functions a call launched: those a CUDA graph of the call
holds, as the driver recorded them (``kernels/_graph.py``), in a tree
that has it, else the dispatch's own record (``flash_gqa.last_launch``)
where the tree has that (torch.profiler's device records were found
partial or empty on the card).
Where the tree's wrapper has the split body (``flash_gqa.body``), a shape
in its range (no mask, Sq <= 16) is timed in it and in the tiled body of
its dtype and head dims (the wgmma body with its kv split, in a tree
whose ``_launch`` takes ``which``; else unsplit), which is how the split
body's Sq limit was chosen. One JSON line a (tree, shape, dtype, body).

Usage (on the card; ``--shapes`` picks some of ``SHAPES`` by name):
  PYTHONPATH=src python -m repro_torch.launch.bench_flash \\
      --trees <parent> <change> <change> <parent> [--shapes encoder ...]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# smollm-135m's padded head map: 9/3 heads padded to 16/4, padded query
# heads on kv head 0
SMOLLM_MAP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)
# (name, B, Sq, Skv, H, Hkv, D, Dv, causal, window, kv_head; None: h //
# (H / Hkv)): recurrentgemma-9b's prefill and its window at 4096 tokens;
# whisper-tiny's cross attention at a decode step (Sq 1) and at the
# prefill (Sq 64), Sq around the split body's limit, and its encoder, also
# at 2 x 11 heads, whose 264 items of 128 rows fill one wave of the wgmma
# body's two blocks an SM on 132 SMs exactly (the encoder's 288 leave 24
# past it); smollm-135m's train shape; deepseek-v2-lite's MLA prefill;
# glm4-9b's prefill, whose (128, 128) keeps the mma body (the control)
SHAPES = (
    ("head_dim_256", 4, 512, 512, 16, 1, 256, 256, True, 0, None),
    ("head_dim_256_window", 1, 4096, 4096, 16, 1, 256, 256, True, 2048,
     None),
    ("cross_decode", 4, 1, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_prefill", 4, 64, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_sq2", 4, 2, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_sq8", 4, 8, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_sq16", 4, 16, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_sq17", 4, 17, 1500, 6, 6, 64, 64, False, 0, None),
    ("cross_sq32", 4, 32, 1500, 6, 6, 64, 64, False, 0, None),
    ("encoder", 4, 1500, 1500, 6, 6, 64, 64, False, 0, None),
    ("encoder_one_wave", 2, 1500, 1500, 11, 11, 64, 64, False, 0, None),
    ("smollm_train", 4, 512, 512, 16, 4, 64, 64, True, 0, SMOLLM_MAP),
    ("mla_prefill", 4, 512, 512, 16, 16, 192, 128, True, 0, None),
    ("glm4_prefill", 4, 512, 512, 32, 2, 128, 128, True, 0, None),
)
HBM_BYTES_PER_S = 3.35e12
GRAPH_REPLAYS = 20
PEAK = {"bfloat16": 989e12, "float32": 67e12}

_CHILD = """
import inspect, json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np
import torch
from repro_torch.kernels.flash_gqa import flash_gqa as FK
from repro_torch.kernels.flash_gqa import ops
try:
    from repro_torch.kernels._graph import launched_functions
except ImportError:                 # a tree from before the witness
    launched_functions = None

tree, shapes, iters, bw = (sys.argv[1], json.loads(sys.argv[2]),
                           int(sys.argv[3]), float(sys.argv[4]))
peak, replays = json.loads(sys.argv[5]), int(sys.argv[6])
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


def graph_ms(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * iters)


for name, B, Sq, Skv, H, Hkv, D, Dv, causal, window, kv_head in shapes:
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        rng = np.random.default_rng(Sq + Skv + D)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda().to(dt) for s in (
            (B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)))
        kw = dict(causal=causal, window=window)
        named, bodies = None, [None]
        if hasattr(FK, "body"):
            named = FK.body(q.shape, v.shape, dt, **kw)
            bodies = [named]
            if not causal and not window and Sq <= 16:
                tiled = ("fma" if dtype == "float32" else "wgmma"
                         if (D, Dv) in getattr(FK, "WGMMA_PAIRS", ())
                         else "mma")
                bodies = ["split", tiled]
        takes_which = "which" in inspect.signature(FK._launch).parameters
        flops, nbytes = ops.work(q.shape, k.shape, v.shape,
                                 elem_bytes=q.element_size(), **kw)
        mask = None
        if window:
            i = torch.arange(Sq, device="cuda")
            mask = ((i[None] <= i[:, None]) | (not causal)) \\
                & (i[None] > i[:, None] - window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if kv_head is not None:
            # no GQA layout the library takes: k and v expanded to the H
            # query heads beforehand, outside the timing
            m = torch.tensor(kv_head, device="cuda")
            kt, vt = kt.index_select(1, m), vt.index_select(1, m)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and not window, enable_gqa=True)
        lib_ev = events_ms(library)
        lib_dev = graph_ms(library)
        for which in bodies:
            if which == named:
                def kernel():
                    return FK.flash_gqa(q, k, v, kv_head=kv_head, **kw)
            elif takes_which:
                def kernel(which=which):
                    return FK._launch(q, k, v, kv_head=kv_head, which=which,
                                      **kw)
            else:                   # an older tree: the tiled body, unsplit
                def kernel():
                    return FK._launch(q, k, v, kv_head=kv_head, tiled=True,
                                      **kw)
            want = library().transpose(1, 2).float()
            err = float((kernel().float() - want).abs().max())
            dev = graph_ms(kernel)
            if launched_functions is not None:
                names = launched_functions(kernel)
            else:
                kernel()
                names = (FK.last_launch() if hasattr(FK, "last_launch")
                         else None)
            print(json.dumps({
                "tree": tree, "shape": name, "dtype": dtype,
                "body": which, "q": [B, Sq, H, D], "kv": [B, Skv, Hkv, D],
                "dv": Dv, "kv_head": kv_head, "causal": causal,
                "window": window,
                "kernel_ms": events_ms(kernel), "kernel_device_ms": dev,
                "cuda_functions": names, "library_ms": lib_ev,
                "library_device_ms": lib_dev,
                "bound_ms": max(flops / peak[dtype], nbytes / bw) * 1e3,
                "max_abs_err_vs_library": err}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="names of SHAPES to time (default: all)")
    args = ap.parse_args(argv)
    shapes = [s for s in SHAPES if args.shapes is None or s[0] in args.shapes]
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
            [sys.executable, "-c", _CHILD, tree, json.dumps(shapes),
             str(args.iters), str(HBM_BYTES_PER_S),
             json.dumps(PEAK), str(GRAPH_REPLAYS)], capture_output=True, text=True, check=False)
        sys.stdout.write(res.stdout)
        if res.returncode:
            sys.stderr.write(res.stderr[-3000:])
            return res.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
