"""The reference's compiled SPMD counts of the smoke mesh cells, which the
port's mesh tests hold their step accounting against
(``tests/_torch_mesh.py:holds_on_mesh``).

For every arch's smoke config, cut as ``_torch_mesh.LAYERS`` cuts it, and
every cell of ``_torch_mesh.CELLS``, the JAX package lowers and compiles
the step on a fake mesh of 8 host devices with its own shardings (train
with ``out_shardings=(state_sh, None)``, decode with ``(None, cache_sh)``,
as ``repro.launch.dryrun.lower_cell`` does) and ``hlo_analysis.analyze``
counts each device's FLOPs and collective bytes. The cells of
``_torch_mesh.ONE_DEVICE_CELLS`` (mesh name "1") compile the same steps
on one device with no mesh. The numbers go to
``tests/data/torch_mesh_reference.json``, which the port's tests read
without JAX (so they also run where JAX is not installed).

The compile runs in a child process whose ``XLA_FLAGS`` asks for 8 host
devices, set before JAX starts; it does not import ``repro.launch.dryrun``,
whose first line asks for 512. A second child of 512 devices gives the
reference's ``abstract_tree`` of every arch on the production meshes
(``abstract_trees``, for ``tests/test_torch_dryrun.py``).

Usage (JAX installed; about 2 minutes on 8 CPU cores):
  PYTHONPATH=src python tests/make_torch_mesh_reference.py
  PYTHONPATH=src python tests/make_torch_mesh_reference.py \
      --only glm4-9b:train:2x4 --print
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE / "data" / "torch_mesh_reference.json"
DEVICES = 8
COMMAND = "PYTHONPATH=src python tests/make_torch_mesh_reference.py"


def _mesh_spec():
    sys.path.insert(0, str(HERE))
    from _torch_mesh import B, CELLS, LAYERS, MESHES, ONE_DEVICE_CELLS, S
    return B, S, CELLS + ONE_DEVICE_CELLS, LAYERS, MESHES


def key(arch: str, kind: str, mesh_name: str) -> str:
    return f"{arch}:{kind}:{mesh_name}"


def _count(cells: list[str]) -> dict:
    """In the child process: each cell ``arch:kind:mesh`` compiled by the
    reference and analyzed -> {cell: counts}."""
    import jax

    from repro.configs.base import ShapeConfig
    from repro.configs.smoke import smoke_config
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    make_train_step)
    from repro.models.model import build_model
    from repro.models.modules import abstract_params
    from repro.parallel.sharding import effective_rules, param_shardings
    from repro.runtime.optimizer import make_optimizer

    B, S, _, LAYERS, MESHES = _mesh_spec()
    assert len(jax.devices()) >= DEVICES, jax.devices()
    meshes = {name: jax.make_mesh(
        shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
        for name, (shape, axes) in MESHES.items()}
    out = {}
    for cell in cells:
        arch, kind, mesh_name = cell.split(":")
        mesh = meshes.get(mesh_name)          # None: one device ("1")
        cfg = smoke_config(arch).replace(num_layers=LAYERS.get(arch, 2))
        if cfg.family == "audio":
            cfg = cfg.replace(encoder_layers=1)
        shape = ShapeConfig("smoke", S, B, kind)
        rules = effective_rules(cfg)
        bundle = build_model(cfg, mesh=mesh, rules=rules)

        def tree(defs):
            if mesh is None:
                return abstract_params(defs)
            return abstract_params(defs, param_shardings(defs, mesh, rules))

        def pinned(defs):
            return None if mesh is None else param_shardings(defs, mesh,
                                                             rules)

        batch = tree(bundle.batch_defs(shape))
        if kind == "train":
            step, state_defs = make_train_step(
                bundle, make_optimizer(cfg.optimizer))
            lowered = jax.jit(step, out_shardings=(pinned(state_defs),
                                                   None)).lower(
                tree(state_defs), batch)
        elif kind == "prefill":
            lowered = jax.jit(make_prefill_step(bundle)).lower(
                tree(bundle.param_defs), batch)
        else:
            cache_defs = bundle.cache_defs(B, S, S >= 2 ** 19)
            lowered = jax.jit(make_decode_step(bundle),
                              out_shardings=(None, pinned(cache_defs))
                              ).lower(tree(bundle.param_defs),
                                      tree(cache_defs), batch)
        ha = analyze(lowered.compile().as_text(),
                     1 if mesh is None else DEVICES)
        out[cell] = {"flops": ha["flops"],
                     "collective_bytes_by_kind":
                         ha["collective_bytes_by_kind"],
                     "collective_total_bytes": ha["collective_total_bytes"]}
        print(f"{cell}: {out[cell]}", file=sys.stderr, flush=True)
    return out


def _abstract() -> dict:
    """In a child process of 512 host devices: the reference's
    ``abstract_tree`` of every arch's parameters on both production meshes
    -> {arch: {mesh: [[shape, dtype, spec], ...] in leaf order}}, a spec
    as one list of mesh axes per dim."""
    from repro.launch import dryrun   # sets 512 devices before JAX starts
    import jax

    from repro.configs.base import get_config, registry
    from repro.launch.mesh import make_mesh_by_name
    from repro.models.model import build_model

    def spec(entry):
        return [] if entry is None else [entry] if isinstance(
            entry, str) else list(entry)

    out = {}
    for arch in sorted(registry()):
        defs = build_model(get_config(arch)).param_defs
        out[arch] = {}
        for name in ("single", "multi"):
            leaves = jax.tree.leaves(dryrun.abstract_tree(
                defs, make_mesh_by_name(name)))
            out[arch][name] = [
                [list(x.shape), str(x.dtype),
                 [spec(e) for e in tuple(x.sharding.spec)
                  + (None,) * (len(x.shape) - len(x.sharding.spec))]]
                for x in leaves]
    return out


def _child(args: list[str], devices: int):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    res = subprocess.run([sys.executable, __file__, *args], env=env,
                         capture_output=True, text=True, check=False)
    if res.returncode:
        raise RuntimeError(f"the reference failed:\n{res.stderr}")
    return json.loads(res.stdout)


def abstract_trees() -> dict:
    """The reference's ``abstract_tree`` of every arch on both production
    meshes, from a child process (``_abstract``)."""
    return _child(["--abstract"], 512)


def compute(cells: list[str]) -> dict:
    """The reference's counts of ``cells``, compiled in a child process on
    8 host devices -> {cell: {"flops", "collective_bytes_by_kind",
    "collective_total_bytes"}}."""
    return _child(["--child", *cells], DEVICES)


def all_cells() -> list[str]:
    from repro.configs.base import registry
    _, _, cells, _, _ = _mesh_spec()
    return [key(a, kind, m) for a in sorted(registry()) for kind, m in cells]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs="*", default=None)
    ap.add_argument("--abstract", action="store_true")
    ap.add_argument("--only", nargs="*", default=None,
                    help="cells arch:kind:mesh (default: all)")
    ap.add_argument("--print", action="store_true",
                    help="print the counts; do not write the file")
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(_count(args.child)))
        return
    if args.abstract:
        print(json.dumps(_abstract()))
        return
    import jax
    counts = compute(args.only or all_cells())
    if args.print:
        print(json.dumps(counts, indent=1))
        return
    B, S, _, LAYERS, _ = _mesh_spec()
    cells = json.loads(OUT.read_text())["cells"] \
        if args.only and OUT.exists() else {}      # --only updates those
    cells.update(counts)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "jax": jax.__version__, "command": COMMAND, "devices": DEVICES,
        "batch": B, "seq": S, "layers": LAYERS,
        "cells": dict(sorted(cells.items()))}, indent=1) + "\n")
    print(f"wrote {len(counts)} cells to {OUT}")


if __name__ == "__main__":
    main()
