"""Multi-pod dry run: every (arch x shape x mesh) cell, on no card
(PyTorch port of ``repro.launch.dryrun``).

For each cell this
  * builds the step (train: ``make_train_step`` with the config's
    optimizer; prefill and decode: ``bundle.prefill_fn`` / ``decode_fn``
    under ``torch.no_grad()``) over DTensor parameters, optimizer state,
    caches and batches laid out by the logical-axis rules
    (``parallel/sharding.py``) on a mesh of H100s over a fake process
    group (``launch/mesh.py``), with meta local shards: nothing is
    allocated;
  * runs it once under ``launch/step_analysis.analyze``, which counts
    each device's FLOPs, HBM bytes, collective bytes and live memory; the
    kernels' entry points run a shape-only launch and count their
    ``work``;
  * writes one JSON record per cell under ``dryrun_out/`` at the repo root
    (and, with ``--save-ops``, the per-operation rows that
    ``launch/breakdown.py`` reads: the counterpart of ``--save-hlo``).

The roofline terms are predictions from data-sheet peaks of one H100 SXM
(``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``), not measurements.
``collective_s`` prices every collective byte at NVLink's 450 GB/s each
way; an axis of more than 8 devices crosses hosts, whose network that
figure does not cover, so on the production meshes (16-way axes) the term
is a lower bound.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._ops import utils as _ops_utils
from torch.distributed.tensor._redistribute import redistribute_local_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.configs.base import (SHAPES, ShapeConfig, cells, get_config,
                                      registry)
from repro_torch.launch.mesh import make_mesh_by_name, mesh_chips
from repro_torch.launch.step_analysis import analyze
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.models.modules import (abstract_params, init_params,
                                        param_count)
from repro_torch.parallel.sharding import effective_rules, param_shardings
from repro_torch.runtime.optimizer import make_optimizer

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"

# --- one NVIDIA H100 SXM (hopper-kernels guide's table; NVIDIA's data
# sheet: dense bf16 tensor-core rate, HBM3, NVLink 4 each way) ---
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink bytes/s each way per card (within a
                             # host of 8; not the network between hosts)
HBM_PER_CHIP = 80e9          # bytes of HBM per card

def abstract_tree(defs, mesh, rules=None):
    """The DTensor tree of ``defs`` laid out by the rules on ``mesh``, over
    meta local shards (nothing allocated)."""
    return abstract_params(defs, param_shardings(defs, mesh, rules))


# ---------------------------------------------------------------------------
# model flops (6*N*D with N = active non-embedding params)
# ---------------------------------------------------------------------------

def active_params(cfg, defs) -> int:
    total = param_count(defs)
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = total - emb
    if cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = (cfg.num_layers - m.first_dense) if m.every_k_layers == 1 \
            else cfg.num_layers // m.every_k_layers
        expert_p = 3 * cfg.d_model * m.expert_d_ff
        routed_total = n_moe_layers * m.num_experts * expert_p
        routed_active = n_moe_layers * m.top_k * expert_p
        n = n - routed_total + routed_active
    return max(n, 0)


def model_flops(cfg, defs, shape: ShapeConfig) -> float:
    n = active_params(cfg, defs)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token / seq


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def _apply_variant(cfg, variant: str | None):
    """--variant k=v[,k=v...]: cfg.replace overrides for perf iterations."""
    if not variant:
        return cfg
    kw = {}
    for item in variant.split(","):
        k, v = item.split("=")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v.lower() in ("1", "true")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return cfg.replace(**kw)


_aten = torch.ops.aten
_VIEWS = {_aten.view.default, _aten._unsafe_view.default}
_PRODUCTS = {_aten.mm.default, _aten.addmm.default}
_NEW = {_aten.new_zeros.default, _aten.new_empty.default,
        _aten.new_ones.default, _aten.new_full.default}
# operations that DTensor has no strategy for at some layouts the dry run
# gives them, in some release; Reshards runs them on operands gathered
# whole and counts them (the record's ``fallback_ops``). None since the
# model states its layouts on a mesh: the embedding's gradient, whose
# index_put had no torch 2.11 strategy, is taken on local shards
# (models/modules.py:Sharder.lookup), as is the MoE dispatch's
KNOWN_GAPS: frozenset[str] = frozenset()


class Reshards(TorchDispatchMode):
    """Layouts that GSPMD would give and DTensor does not, at the
    DTensor level of dispatch (so a backward and its recompute take them
    too):
      * a new tensor of a DTensor's rank (``new_zeros``: the gradient of
        a gather) keeps its splits on the dims of equal size, where
        DTensor would replicate it whole on every device;
      * where DTensor cannot view a sharded tensor as a new shape (a dim
        split unevenly by its mesh dim: glm4's 2 kv heads x 128 from a
        256-wide projection sharded 16 ways; or a local view that does not
        fit its shard: the decode scores' einsum over a sequence-sharded
        cache), the dims that the view changes are gathered and the view
        runs again; the dims before the first one it changes keep their
        splits;
      * a product of rows split over a mesh dim with a weight whose
        contraction dim is split over the same one gathers the weight
        there (FSDP), where DTensor may gather the rows instead and sum
        partial products;
      * an unbind along a sharded dim gathers that dim first;
      * a write into a cache split along the written dim
        (``index_copy_`` of a decode step into a sequence-sharded cache)
        writes this device's shard in place, where DTensor would gather
        the cache and lose the write;
      * an operation that DTensor has no strategy for at its operands'
        layouts runs on them gathered whole, if it is one of
        ``KNOWN_GAPS``; it is counted in ``fallbacks`` by op name, and any
        other such operation fails the cell."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if not isinstance(x, DTensor):
            return func(*args, **kwargs)
        if func in _NEW and len(args[1]) == x.dim():
            size = list(args[1])
            lay = [p if p.is_shard() and size[p.dim] == x.shape[p.dim]
                   else Replicate() for p in x.placements]
            local, _ = compute_local_shape_and_global_offset(
                size, x.device_mesh, lay)
            return _dtensor(func(x._local_tensor, list(local), *args[2:],
                                 **kwargs), x.device_mesh, lay, size)
        if func is _aten.unbind.int:
            dim = (args[1] if len(args) > 1 else 0) % x.dim()
            return func(_gathered(x, dim), *args[1:], **kwargs)
        if func is _aten.index_copy_.default and any(
                p.is_shard(args[1] % x.dim()) for p in x.placements):
            dim, index, src = args[1] % x.dim(), args[2], args[3]
            src = _resharded(src, [Replicate() if p.is_shard(dim) else p
                                   for p in x.placements])
            if isinstance(index, DTensor):
                index = _resharded(index, [Replicate()] * index.ndim
                                   )._local_tensor
            x._local_tensor.index_copy_(dim, index, src._local_tensor)
            return x
        if func in _VIEWS:
            try:
                return func(*args, **kwargs)
            except RuntimeError:
                pass
            new = list(args[1])
            same = 0
            while same < min(len(new), x.dim()) and new[same] == x.shape[same]:
                same += 1
            keep = [p if p.is_shard() and p.dim < same else Replicate()
                    for p in x.placements]
            return func(_resharded(x, keep), *args[1:], **kwargs)
        if func in _PRODUCTS:
            i = 1 if func is _aten.mm.default else 2
            a, w = args[i - 1], args[i]
            if isinstance(a, DTensor) and isinstance(w, DTensor):
                lay = [Replicate() if pw.is_shard(0) and pa.is_shard(0)
                       else pw for pa, pw in zip(a.placements, w.placements)]
                args = (*args[:i], _resharded(w, lay), *args[i + 1:])
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            # an operation DTensor has no strategy for at these layouts:
            # a known gap runs on its operands gathered whole, but self
            # where it writes in place; if that fails too, the first error
            # stands
            name = func._schema.name.split("::")[1]
            if name not in KNOWN_GAPS:
                raise NotImplementedError(
                    f"{name}: DTensor has no strategy at these layouts and "
                    "it is not one of dryrun.KNOWN_GAPS (ROADMAP Queue C)"
                ) from e
            inplace = name.endswith("_")
            whole = [a if i == 0 and inplace else _replicated(a)
                     for i, a in enumerate(args)]
            try:
                out = func(*whole, **{k: _replicated(v)
                                      for k, v in kwargs.items()})
            except (RuntimeError, NotImplementedError):
                raise e from None
            self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        return out


def _dtensor(local, mesh, placements, shape) -> DTensor:
    """A DTensor over ``local``, made below autograd (inside dispatch,
    where DTensor's autograd functions must not run)."""
    spec = DTensorSpec(mesh, tuple(placements), tensor_meta=TensorMeta(
        torch.Size(shape), kernels.strides(shape), local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _resharded(x: DTensor, placements) -> DTensor:
    """``x`` laid out by ``placements``, made below autograd."""
    placements = tuple(placements)
    if placements == tuple(x.placements):
        return x
    spec = DTensorSpec(x.device_mesh, placements,
                       tensor_meta=x._spec.tensor_meta)
    return DTensor(redistribute_local_tensor(x._local_tensor, x._spec, spec),
                   spec, requires_grad=False)


def _replicated(a):
    """``a`` (a DTensor, or a list or tuple of them) replicated whole."""
    if isinstance(a, DTensor):
        return _resharded(a, [Replicate()] * a.device_mesh.ndim)
    if isinstance(a, (list, tuple)):
        return type(a)(_replicated(x) for x in a)
    return a


def _gathered(x: DTensor, dim: int) -> DTensor:
    return _resharded(x, [Replicate() if p.is_shard(dim) else p
                          for p in x.placements])


def _strided(spec) -> bool:
    return any(isinstance(p, _StridedShard) for p in spec.placements)


def _cost(cur, tgt) -> float:
    """DTensor's redistribution cost for choosing among an operation's
    strategies, but where either layout holds a strided shard (a dim
    flattened from dims split over two mesh dims: every batch x sequence
    view on a 3-D mesh) one unit a mesh dim that changes: DTensor plans
    those by a graph search per candidate, minutes an operation on a 3-D
    mesh. The redistribution chosen is still planned exactly."""
    if not (_strided(cur) or _strided(tgt)):
        return _dtensor_cost(cur, tgt)
    return float(sum(a != b for a, b in zip(cur.placements, tgt.placements)))


_dtensor_cost = getattr(_ops_utils, "redistribute_cost", None)


@contextlib.contextmanager
def _quick_costs():
    if _dtensor_cost is None:            # a DTensor that plans otherwise
        yield
        return
    _ops_utils.redistribute_cost = _cost
    try:
        yield
    finally:
        _ops_utils.redistribute_cost = _dtensor_cost


def step_and_defs(bundle, shape: ShapeConfig):
    """-> (the step function of ``shape``'s kind, the ParamSpec trees of its
    arguments): train ``make_train_step`` with the config's optimizer over
    (state, batch); prefill ``bundle.prefill_fn`` over (params, batch) and
    decode ``bundle.decode_fn`` over (params, cache, batch), both under
    ``torch.no_grad()``."""
    cfg = bundle.cfg
    batch = bundle.batch_defs(shape)
    if shape.kind == "train":
        step_fn, state_defs = make_train_step(
            bundle, make_optimizer(cfg.optimizer))
        return step_fn, (state_defs, batch)
    if shape.kind == "prefill":
        return torch.no_grad()(bundle.prefill_fn), (bundle.param_defs, batch)
    cache = bundle.cache_defs(shape.global_batch, shape.seq_len,
                              shape.seq_len >= 2 ** 19)
    return torch.no_grad()(bundle.decode_fn), (bundle.param_defs, cache,
                                               batch)


def step_and_args(bundle, shape: ShapeConfig, mesh=None, rules=None):
    """-> (the step, its abstract arguments): meta tensors with
    ``mesh=None``, else DTensors laid out by the rules on ``mesh`` over
    meta local shards."""
    step_fn, defs = step_and_defs(bundle, shape)
    return step_fn, tuple(abstract_params(d) if mesh is None
                          else abstract_tree(d, mesh, rules) for d in defs)


_last_cfg = None                  # the config of the last cell lowered


def _clear_sharding_caches() -> None:
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        getattr(getattr(prop, name, None), "cache_clear", lambda: None)()
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
            lambda: None)()


def lower_cell(arch: str, shape: str | ShapeConfig, mesh,
               variant: str | None = None, cfg=None, record_ops=False):
    """Build one cell's step on ``mesh`` and run it once under the step
    analysis. ``cfg`` overrides the arch's config (tests pass smoke
    configs), ``shape`` may be a ShapeConfig. -> (analysis, with
    ``fallback_ops``: the operations of ``KNOWN_GAPS`` run gathered whole,
    by name; meta)."""
    cfg = _apply_variant(cfg or get_config(arch), variant)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    # DTensor's caches of propagated shardings can hand one config's output
    # shape to another's call with other scalar arguments (topk's k:
    # deepseek's 2, llama4's 1), so a cell of another config than the last
    # starts with them empty
    global _last_cfg
    if cfg != _last_cfg:
        _clear_sharding_caches()
        _last_cfg = cfg
    rules = effective_rules(cfg)
    bundle = build_model(cfg, mesh=mesh, rules=rules)
    step_fn, args = step_and_args(bundle, shape, mesh, rules)
    reshards = Reshards()

    def step(*a):
        with reshards:
            return step_fn(*a)

    with implicit_replication(), _quick_costs():
        _, ana = analyze(step, *args, record_ops=record_ops)
    ana["fallback_ops"] = dict(sorted(reshards.fallbacks.items()))
    return ana, {"cfg": cfg, "bundle": bundle, "shape": shape}


def card_check(cfg, shape: ShapeConfig, device, seed: int = 0,
               timed: int = 2) -> dict:
    """The step analysis held against the card, on one device and no mesh:
    one step of ``cfg`` at ``shape`` on ``device`` (arguments drawn from
    ``seed`` by ``init_params``: parameters random, optimizer state and
    batch at their defs' zeros and ones), a warm-up and ``timed`` steps
    timed on the host clock around synchronized steps, then one step
    under ``analyze`` with the peak memory counters reset; and the same
    step on meta tensors under ``analyze``. -> {"card", "meta" (the two
    analyses), "card_peak_bytes" (``max_memory_allocated`` during the
    analyzed step), "allocated_before" (``memory_allocated`` before it),
    "step_s" (the mean timed step), "card_steps" (the steps run on the
    card: ``timed`` + 2), "model_flops"}."""
    bundle = build_model(cfg)
    step_fn, defs = step_and_defs(bundle, shape)
    gen = torch.Generator(device).manual_seed(seed)
    args = tuple(init_params(d, gen, device) for d in defs)

    def step():
        out = step_fn(*args)
        if shape.kind == "train":        # the step's new state
            args[0]["step"] = out[0]["step"]
        return out

    step()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    _, card = analyze(step_fn, *args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del args
    _, meta = analyze(step_fn, *step_and_args(bundle, shape)[1])
    return {"card": card, "meta": meta, "card_peak_bytes": peak,
            "allocated_before": before, "step_s": sum(times) / len(times),
            "card_steps": timed + 2,
            "model_flops": model_flops(cfg, bundle.param_defs, shape)}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             save_ops: bool = False, variant: str | None = None) -> dict:
    """One cell on a production mesh -> its record (also written to
    ``OUT_DIR`` as ``<arch>__<shape>__<mesh>.json``)."""
    t0 = time.time()
    mesh = make_mesh_by_name(mesh_name)
    chips = mesh_chips(mesh)
    ha, meta = lower_cell(arch, shape_name, mesh, variant,
                          record_ops=save_ops)
    cfg, bundle, shape = meta["cfg"], meta["bundle"], meta["shape"]
    colls = {"bytes_by_kind": ha["collective_bytes_by_kind"],
             "count_by_kind": ha["collective_count_by_kind"],
             "total_bytes": ha["collective_total_bytes"]}
    flops_dev = float(ha["flops"])
    bytes_dev = float(ha["memory_bytes"])
    mf = model_flops(cfg, bundle.param_defs, shape)

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = colls["total_bytes"] / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "wall_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": ha["argument_bytes"],
            "peak_estimate_bytes": ha["peak_bytes"],
            "hbm_per_chip": HBM_PER_CHIP,
            "fits": ha["peak_bytes"] < HBM_PER_CHIP,
        },
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device": bytes_dev,
                 "kernel_calls": ha["kernel_calls"]},
        "collectives": colls,
        "roofline": {
            **terms,
            "dominant": dominant,
            "model_flops_total": mf,
            "model_flops_per_device": mf / chips,
            "useful_flops_ratio": (mf / chips) / flops_dev if flops_dev else 0.0,
            "step_time_lower_bound_s": max(terms.values()),
        },
        "params_total": param_count(bundle.param_defs),
        "params_active": active_params(cfg, bundle.param_defs),
        "fallback_ops": ha["fallback_ops"],
    }
    rec["variant"] = variant or ""
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{variant.replace('=', '-').replace(',', '_')}" if variant
        else "")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    if save_ops:
        (OUT_DIR / f"{tag}.ops.json").write_text(json.dumps(
            {"chips": chips, "ops": ha["ops"]}))
    return rec


def line(rec: dict) -> str:
    """A record's one-line summary, as the reference's CLI prints it."""
    r = rec["roofline"]
    return (f"{rec['wall_s']}s mem/dev "
            f"{rec['memory']['peak_estimate_bytes'] / 1e9:.2f}GB "
            f"fits={rec['memory']['fits']} "
            f"compute {r['compute_s'] * 1e3:.2f}ms "
            f"memory {r['memory_s'] * 1e3:.2f}ms "
            f"coll {r['collective_s'] * 1e3:.2f}ms "
            f"dominant={r['dominant']} "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"fallbacks={rec['fallback_ops'] or 0}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-ops", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="cfg overrides k=v[,k=v] for perf iterations")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        targets = [(a, s) for a in sorted(registry()) for s in cells(a)]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else cells(args.arch)
        targets = [(args.arch, s) for s in shapes]

    failures = []
    for arch, shape in targets:
        for mesh_name in meshes:
            tag = f"{arch} x {shape} x {mesh_name}"
            out = OUT_DIR / f"{arch}__{shape}__{mesh_name}.json"
            if args.skip_existing and out.exists():
                print(f"[skip] {tag}")
                continue
            try:
                rec = run_cell(arch, shape, mesh_name, save_ops=args.save_ops,
                               variant=args.variant)
                print(f"[ ok ] {tag}: {line(rec)}", flush=True)
            except Exception as e:  # noqa: BLE001 — report all cell failures
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
