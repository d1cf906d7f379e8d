"""Batched serving demo of the PyTorch port: prefill + greedy decode on a
reduced config, for a GQA transformer AND an attention-free SSM (different
cache structures); examples/serve_decode.py on repro_torch.

  PYTHONPATH=src python examples/torch/serve_decode.py [--device cuda|cpu]
"""
import argparse
import os
import pathlib
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default: cuda)")
args = ap.parse_args()

root = pathlib.Path(__file__).resolve().parents[2]
for arch in ("glm4-9b", "mamba2-2.7b"):
    print(f"=== {arch} (reduced config) ===", flush=True)
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--prompt-len", "8", "--new-tokens", "6", "--batch", "2",
         "--device", args.device],
        env={**os.environ, "PYTHONPATH": str(root / "src")}, check=True)
