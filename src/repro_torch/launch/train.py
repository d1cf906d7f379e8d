"""Training driver: elastic, fault-tolerant step-task loop over any arch,
on a torch device (PyTorch port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 16 --steps-per-task 4 [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.configs.smoke import smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import build_model
from repro_torch.objectstore.store import ObjectStore, StoreConfig
from repro_torch.runtime.train_loop import ElasticTrainer, JobConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--steps-per-task", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject one worker failure at this global step")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build_model(cfg)
    store = ObjectStore(StoreConfig(seed=0, simulate_visibility_lag=False))
    fails = {args.fail_at: 1} if args.fail_at >= 0 else {}

    def hook(task, step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            print(f"[inject] worker failure at step {step}")
            return True
        return False

    job = JobConfig(steps_per_task=args.steps_per_task,
                    total_steps=args.steps, batch=args.batch, seq=args.seq)
    trainer = ElasticTrainer(bundle, store, job, failure_hook=hook,
                             device=dev)
    log = trainer.run()
    for m in log:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}")
    print(f"done: {len(log)} committed checkpoints, "
          f"{store.stats.puts} PUTs / {store.stats.gets} GETs to the store")


if __name__ == "__main__":
    main()
