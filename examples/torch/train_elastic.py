"""Fault-tolerant training demo of the PyTorch port: kill a worker mid-run,
watch the job recover bit-exact from the object-store checkpoint; then
resume a finished job (no-op) to show idempotent step-tasks
(examples/train_elastic.py on repro_torch).

  PYTHONPATH=src python examples/torch/train_elastic.py [arch] \\
      [--device cuda|cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch.runtime.train_loop import ElasticTrainer, JobConfig  # noqa

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="mamba2-2.7b")
ap.add_argument("--device", default="cuda",
                help="torch device (default: cuda)")
args = ap.parse_args()

arch = args.arch
job = JobConfig(steps_per_task=2, total_steps=8, batch=4, seq=32)

print(f"=== clean run ({arch}, reduced config) ===")
t0 = ElasticTrainer(build_model(smoke_config(arch)),
                    ObjectStore(StoreConfig(simulate_visibility_lag=False)),
                    job, device=args.device)
clean = t0.run()
for m in clean:
    print(f"  step {m['step']} loss {m['loss']:.4f}")

print("=== run with two injected worker deaths ===")
fails = {(1, 3): 1, (2, 4): 1}


def hook(task, step):
    if fails.get((task, step), 0):
        fails[(task, step)] -= 1
        print(f"  !! worker died in task {task} at step {step} "
              "-> coordinator reschedules")
        return True
    return False


t1 = ElasticTrainer(build_model(smoke_config(arch)),
                    ObjectStore(StoreConfig(simulate_visibility_lag=False)),
                    job, failure_hook=hook, device=args.device)
faulty = t1.run()
for m in faulty:
    print(f"  step {m['step']} loss {m['loss']:.4f}")

same = np.allclose([m["loss"] for m in clean], [m["loss"] for m in faulty],
                   rtol=0, atol=0)
print(f"loss trajectories bit-exact across failures: {same}")
assert same

print("=== the finished job resumed (every task already committed) ===")
again = ElasticTrainer(build_model(smoke_config(arch)), t1.store, job,
                       device=args.device).run()
print(f"  tasks re-run: {len(again)}")
assert again == []
