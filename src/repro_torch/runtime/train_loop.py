"""Elastic, fault-tolerant training runtime — Starling C1 for training
(PyTorch port of ``repro.runtime.train_loop``).

A training job is a DAG (here: a chain) of *step-tasks*. Each task:
  input  = checkpoint step k (object store) + deterministic data cursor
  work   = `steps_per_task` optimizer steps
  output = checkpoint step k+n, committed by a conditional manifest PUT

Stateless workers => node failure is handled by RE-RUNNING the task (same
inputs, identical result); stragglers by DUPLICATING the task (first
manifest write wins — the store's atomic conditional PUT); ELASTIC re-mesh
happens between tasks because checkpoints are stored mesh-independently
(runtime/checkpoint.py) — a new worker pool of any size range-reads its
shards and continues.

The train step (``launch/steps.make_train_step``) updates the state in
place, so an attempt never reuses a state that another attempt touched:
every attempt initializes (task 0) or restores its state afresh. The
restore template is the state's ParamSpec tree, so a restore holds one
state, not a second one drawn for its structure. A re-run task gives the
same bits as its first run only if a train step does on the device: the
port's train step has no float atomics in an order that varies
(``kernels/_autograd.py:index_select``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.stragglers import StragglerConfig
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import ModelBundle
from repro_torch.models.modules import tree_map
from repro_torch.objectstore.store import ObjectStore
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import SyntheticCorpus
from repro_torch.runtime.optimizer import make_optimizer


class TaskFailure(Exception):
    pass


@dataclasses.dataclass
class JobConfig:
    steps_per_task: int = 4
    total_steps: int = 16
    batch: int = 8
    seq: int = 32
    ckpt_shards: int = 4


class ElasticTrainer:
    def __init__(self, bundle: ModelBundle, store: ObjectStore,
                 job: JobConfig, *, seed: int = 0,
                 policy: StragglerConfig | None = None,
                 failure_hook: Callable[[int, int], bool] | None = None,
                 device=None):
        self.bundle = bundle
        self.store = store
        self.job = job
        self.seed = seed
        self.device = resolve_device(device)
        self.policy = policy or StragglerConfig()
        self.failure_hook = failure_hook or (lambda task, step: False)
        self.opt = make_optimizer(bundle.cfg.optimizer, lr=1e-3)
        self.step_fn, self.state_defs = make_train_step(bundle, self.opt)
        self.ckpt = CheckpointManager(store, bundle.cfg.name, self.policy,
                                      n_shards=job.ckpt_shards, seed=seed)
        self.data = SyntheticCorpus(bundle.cfg.vocab_size, seed)
        self.metrics_log: list[dict] = []

    # ---------------------------------------------------------------- tasks
    def _init_state(self) -> dict:
        return init_train_state(
            self.bundle, self.opt,
            torch.Generator(self.device).manual_seed(self.seed), self.device)

    def _restore_state(self, step: int) -> dict:
        state, _ = self.ckpt.restore_state(self.state_defs, step)
        return tree_map(lambda t: t.to(self.device), state,
                        is_leaf=torch.is_tensor)

    def run_task(self, task_id: int, worker_id: int = 0) -> int:
        """One stateless step-task. Raises TaskFailure if the (injected)
        fault fires. Returns the committed checkpoint step."""
        start_step = task_id * self.job.steps_per_task
        state = (self._init_state() if task_id == 0
                 else self._restore_state(start_step))
        metrics = None
        for i in range(self.job.steps_per_task):
            step = start_step + i
            if self.failure_hook(task_id, step):
                raise TaskFailure(f"worker {worker_id} died at step {step}")
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in
                     self.data.batch_at(step, self.job.batch,
                                        self.job.seq).items()}
            state, metrics = self.step_fn(state, batch)
        end_step = start_step + self.job.steps_per_task
        won, _ = self.ckpt.save(state, end_step)
        if won and metrics is not None:
            self.metrics_log.append(
                {"step": end_step,
                 "loss": float(metrics["loss"])})
        return end_step

    # ----------------------------------------------------------------- loop
    def run(self, max_retries: int = 3) -> list[dict]:
        """Drive the task chain to total_steps, rescheduling failed tasks."""
        n_tasks = self.job.total_steps // self.job.steps_per_task
        task = 0
        while task < n_tasks:
            # resume support: skip tasks whose checkpoint already exists
            latest = self.ckpt.latest_step()
            if latest is not None and latest >= (task + 1) * \
                    self.job.steps_per_task:
                task = latest // self.job.steps_per_task
                continue
            attempts = 0
            while True:
                try:
                    self.run_task(task, worker_id=attempts)
                    break
                except TaskFailure:
                    attempts += 1
                    if attempts > max_retries:
                        raise
            task += 1
        return self.metrics_log
