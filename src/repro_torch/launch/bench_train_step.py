"""Train step time of the same cells in several source trees, in turns on
one card (say a parent commit and a change: parent, change, change,
parent), so that two versions are compared inside one run.

For each tree (a directory holding ``src/repro_torch``), in the order
given, a child process imports that tree's package and runs
``launch/dryrun.card_check`` on each of ``CELLS``: f32 parameters and
AdamW state, bf16 compute, one 4 x 512 batch from the seed, a warm-up
and ``--timed`` synchronized steps timed on the host clock. One JSON line
a (tree, cell): the mean step ms, the analyzed FLOPs and the card's peak
bytes.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.bench_train_step \\
      --trees <parent> <change> <change> <parent>
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

# (arch, layers; None = the published depth): chip_smoke.py's train cells
CELLS = (("smollm-135m", None), ("deepseek-v2-lite-16b", 3),
         ("mamba2-2.7b", None))
BATCH, SEQ = 4, 512

_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch.dryrun import card_check
for arch, layers in json.loads(sys.argv[2]):
    cfg = get_config(arch).replace(param_dtype=torch.float32,
                                   compute_dtype=torch.bfloat16)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    r = card_check(cfg, ShapeConfig("train", int(sys.argv[4]),
                                    int(sys.argv[3]), "train"),
                   torch.device("cuda"), seed=0, timed=int(sys.argv[5]))
    print(json.dumps({"tree": sys.argv[1], "arch": arch,
                      "layers": cfg.num_layers,
                      "step_ms": r["step_s"] * 1e3,
                      "flops": r["card"]["flops"],
                      "peak_bytes": r["card_peak_bytes"]}), flush=True)
    del r
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--timed", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_train_step needs an NVIDIA card", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, tree, json.dumps(CELLS),
             str(BATCH), str(SEQ), str(args.timed)],
            capture_output=True, text=True, check=False)
        sys.stdout.write(res.stdout)
        if res.returncode:
            sys.stderr.write(res.stderr[-3000:])
            return res.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
