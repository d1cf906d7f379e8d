"""The readings the output check's limits are set from, on the card, in
one process for a cell: for each seed, the pool's own run (a short window
at the cell's load, the sample a full run draws) and the control (the
reference computed with fp8 operands, ``reference/_plain.py: Fp8``, in
the program's place) on the same sampled prompts, each judged against the
float32 reference. One JSON line a seed with every sampled request's
numbers.

  python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
      [--control-seeds 3] [--seconds 4] [--fault <name>] [--compute <dtype>]

``--fault`` reads a fault of ``harness/faults.py`` instead of the sound
program, ``--compute float32`` the program in float32 (a witness that
the reference and the program's path agree at the cell's size).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

from harness import check  # noqa: E402
from harness.main import Pool  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the control runs on the first this many seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="break the timed path (harness/faults.py)")
    ap.add_argument("--compute", default=None,
                    help="run the program in this dtype (a witness)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    pool = Pool(HERE.parent, args.workload, args.seeds[0], args.device,
                fault=args.fault, compute=args.compute)
    pool.warm()
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if n:
            pool.draw(seed)
        recs, held, _ = pool.window(args.seconds)
        logits, served, prompts = pool.sampled(recs, held, seed)
        ref = pool.reference(prompts)
        out = {"workload": args.workload, "seed": seed,
               "fault": args.fault, "compute": args.compute,
               "lengths": [p.numel() for p in prompts],
               "program": {k: v.tolist() for k, v in check.numbers(
                   logits, served, ref).items()}}
        if n < args.control_seeds:
            ctl = pool.reference(prompts, pool.plain.Fp8())
            out["control"] = {k: v.tolist() for k, v in check.numbers(
                ctl, ctl.argmax(-1), ref).items()}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
