"""Does a train step give the same bits every run on the card? The
gradients of one full-width step, computed ``--runs`` times from one
state and one batch, with the backward of the models' gathers
(``kernels/_autograd.py:index_select``: the kv heads of ``flash_gqa``'s
plain version and ``models/transformer.py:_expand_kv``, the MoE dispatch's
rows) taken two ways:

  atomics   ``index_add_``, the backward of ``torch.Tensor.index_select``:
            the rows of a repeated index added by float atomics, in no
            fixed order
  fixed     ``index_put_(accumulate=True)``, the port's: fixed order

  PYTHONPATH=src python -m repro_torch.launch.bench_replay \\
      [--arch smollm-135m mamba2-2.7b glm4-9b deepseek-v2-lite-16b] \\
      [--runs 3]

Each arch at full width, f32 parameters, bf16 compute, B = 4, S = 512,
at the depth of its ``chip_smoke.py`` cell (``LAYERS``): the elastic cells
(smollm-135m, 16 padded q heads over 4; mamba2-2.7b, no gather), and two
whose gathers take more than 16 indices, the count above which
``index_add_`` spreads the indices over threads: glm4-9b's 32 q heads
over 2, and deepseek-v2-lite-16b's MoE dispatch of B·S·k rows, whose
empty slots all read one zero row. Prints one JSON line an
(arch, way): the gradient leaves that differ bitwise from the first run in
a later one, the largest such difference, and ms a step (host clock around
a synchronized ``grads_of``, the mean of the runs after the first). Runs
on CUDA only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import _autograd
from repro_torch.launch.steps import grads_of
from repro_torch.models.model import build_model
from repro_torch.models.modules import init_params, tree_leaves

LAYERS = {"mamba2-2.7b": 4, "glm4-9b": 2, "deepseek-v2-lite-16b": 3}
B, S, SEED = 4, 512, 0


def atomics(ctx, g):
    (index,) = ctx.saved_tensors
    shape = list(g.shape)
    shape[ctx.dim] = ctx.size
    return g.new_zeros(shape).index_add_(ctx.dim, index, g), None, None


@contextlib.contextmanager
def backward_by(fn):
    """The gathers' backward replaced by ``fn`` inside the block (None:
    the port's own)."""
    kept = _autograd._Select.backward
    if fn is not None:
        _autograd._Select.backward = staticmethod(fn)
    try:
        yield
    finally:
        _autograd._Select.backward = kept


def replay(arch: str, runs: int, dev) -> list[dict]:
    cfg = get_config(arch).replace(param_dtype=torch.float32,
                                   compute_dtype=torch.bfloat16)
    if arch in LAYERS:
        cfg = cfg.replace(num_layers=LAYERS[arch])
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs,
                         torch.Generator(dev).manual_seed(SEED), dev)
    seq = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).to(dev)
    batch = {"tokens": seq[:, :-1].contiguous(),
             "targets": seq[:, 1:].contiguous(),
             "mask": torch.ones(B, S, dtype=torch.int32, device=dev)}
    out = []
    for way, fn in (("atomics", atomics), ("fixed", None)):
        first, differ, worst, ms = None, set(), 0.0, []
        with backward_by(fn):
            for r in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grads, _ = grads_of(bundle.loss_fn, params, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                leaves = tree_leaves(grads, torch.is_tensor)
                if first is None:
                    first = leaves
                    continue
                for i, (a, b) in enumerate(zip(first, leaves)):
                    if not torch.equal(a, b):
                        differ.add(i)
                        worst = max(worst, float((a - b).abs().max()))
                del grads, leaves
        out.append({"arch": arch, "layers": cfg.num_layers, "way": way,
                    "runs": runs, "leaves": len(first),
                    "leaves_differing": sorted(differ),
                    "max_abs_difference": worst,
                    "ms_a_step": sum(ms[1:]) / max(len(ms) - 1, 1)})
        del first
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["smollm-135m", "mamba2-2.7b", "glm4-9b",
                             "deepseek-v2-lite-16b"])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    for arch in args.arch:
        for rec in replay(arch, args.runs, dev):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
