"""Quickstart of the PyTorch port: the three public surfaces in one script
(examples/quickstart.py on repro_torch).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]

1. Run a TPC-H query through the Starling engine (coordinator + stateless
   workers + simulated S3 + shuffles + straggler mitigation), the workers'
   operators on the device.
2. Train a reduced-config model for a few steps with the elastic runtime
   (checkpoints through the same object store) on the device.
3. Show the multi-stage-shuffle cost model (the paper's §4.2 arithmetic).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core.engine import make_engine, oracle, run_query  # noqa
from repro_torch.core.shuffle import choose_strategy, single_stage  # noqa
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.objectstore.store import ObjectStore, StoreConfig  # noqa
from repro_torch.runtime.train_loop import ElasticTrainer, JobConfig  # noqa

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (default: cuda)")
args = ap.parse_args()

print("=== 1. query: TPC-H Q12 on the serverless engine ===")
coord, tables = make_engine(sf=0.005, device=args.device)
res = run_query(coord, "q12", {"join": 8})
print(f"latency {res.latency_s:.2f}s (virtual), cost ${res.cost.total:.5f}, "
      f"{res.task_count} tasks, {res.backup_count} backup tasks")
exp = oracle("q12", tables)
print(f"result rows: {len(res.result)} (oracle: {len(exp)})")

print("\n=== 2. train: elastic stateless step-tasks ===")
bundle = build_model(smoke_config("smollm-135m"))
store = ObjectStore(StoreConfig(simulate_visibility_lag=False))
trainer = ElasticTrainer(bundle, store, JobConfig(
    steps_per_task=2, total_steps=6, batch=4, seq=32), device=args.device)
for m in trainer.run():
    print(f"step {m['step']} loss {m['loss']:.4f}")

print("\n=== 3. shuffle planning (paper §4.2) ===")
print(f"single 5120x1280: ${single_stage(5120, 1280).request_cost():.2f}")
best = choose_strategy(5120, 1280)
print(f"chosen: {best.strategy} p=1/{round(1/best.p)} f=1/{round(1/best.f)} "
      f"-> ${best.request_cost():.3f}")
