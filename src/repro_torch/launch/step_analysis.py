"""Per-device accounting of one eager step (the counterpart of
``repro.launch.hlo_analysis``).

The reference walks the compiled, post-SPMD HLO of a step and multiplies
each computation by its loop trip counts. The port runs the step eagerly,
whose Python loops are already unrolled, under a ``TorchDispatchMode``
that sees every ATen operation on the tensors a device holds: plain
tensors on one device, and on a mesh (``launch/mesh.py``) the local shards
that DTensor computes on. It counts

  * FLOPs, from ``torch.utils.flop_counter.flop_registry`` (matrix
    products, convolutions, attention): the reference counts dots;
  * HBM bytes, each operation's tensor operands plus its outputs, with
    views and metadata operations free (``_FREE_OPS``, ``_op_bytes``);
    a scatter into a tensor in place moves its update, not the whole
    destination, as the reference models dynamic-update-slice;
  * collective bytes and counts by kind, from the ``_c10d_functional``
    and ``_dtensor`` collectives on local shapes, by the reference's ring
    model (``_collective_bytes``);
  * the high-water mark of live bytes: every storage an operation
    creates, rounded as the CUDA caching allocator rounds a block (512
    bytes), from its creation until it is freed, plus the step's
    arguments. It stands for XLA's ``memory_analysis``.

A hand-written kernel's entry point (``kernels.entry``) counts as one row
with its ``work`` (FLOPs and bytes of the function), and the operations
inside its launch are not counted, though what they allocate is. On a
mesh, DTensor propagates shardings by running each operation on fake
tensors of the global shapes under a fake mode; those calls are skipped, and the DTensor-level
call is left to DTensor (``NotImplemented``), whose local operations then
come back to the mode.
"""
from __future__ import annotations

import sys
import threading
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
         "broadcast": "collective-permute"}
_aten = torch.ops.aten
# operations that move no data (metadata, aliasing, allocation without a
# write, waits); every view operation is free too (``OpOverload.is_view``)
_FREE_OPS = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.detach.default,
             _aten.lift_fresh.default, _aten._unsafe_view.default,
             _aten._local_scalar_dense.default, _aten.set_.source_Storage,
             _aten.set_.source_Storage_storage_offset,
             torch.ops._c10d_functional.wait_tensor.default,
             torch.ops._c10d_functional._wrap_tensor_autograd.default}
# in-place scatters: they move their update (read, then written), not the
# destination (argument 0) whole
_SCATTERS = {"index_copy_", "index_put_", "_index_put_impl_", "index_add_",
             "scatter_", "scatter_add_", "scatter_reduce_", "index_fill_",
             "masked_scatter_"}
_FAKE = torch._C._TorchDispatchModeKey.FAKE
ROW_BYTES = 10**6                 # the smallest operation an op record keeps
BLOCK = 512                       # the CUDA caching allocator's block


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _alloc(n: int) -> int:
    """A storage of n bytes as the caching allocator holds it."""
    return -(-n // BLOCK) * BLOCK


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _op_bytes(func, args, kwargs, outs) -> int:
    """Approximate HBM traffic of one operation (operands + outputs)."""
    ins = _tensors((args, kwargs))
    if func.__name__.split(".")[0] in _SCATTERS and ins:
        moved = sum(_nbytes(t) for t in ins[1:])
        return moved + _nbytes(ins[-1])
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def _group_size(func, args) -> int:
    name = func._schema.name.split("::")[1]
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[2] if name == "reduce_scatter_tensor" else args[1])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _collective_bytes(func, args, outs) -> tuple[str, float, int]:
    """(kind, modeled per-device ring bytes, group size) of one
    collective, as the reference models it: all-gather its output x
    (g-1)/g, all-reduce twice its size x (g-1)/g, reduce-scatter and
    all-to-all their output x (g-1)/g, a permute its size."""
    kind = _KIND[func._schema.name.split("::")[1]]
    g = _group_size(func, args)
    frac = (g - 1) / g if g > 1 else 0.0
    size = sum(_nbytes(t) for t in outs)
    if kind == "all-reduce":
        return kind, 2 * size * frac, g
    if kind == "collective-permute":
        return kind, size, g
    return kind, size * frac, g


def _frame() -> str:
    """The innermost frame of the port's model or launch code that is on
    the stack (the counterpart of an HLO ``op_name``), or "?"."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not any(
                k in path for k in ("step_analysis", "dryrun", "/kernels/")):
            parts = path.replace("\\", "/").split("/")
            return f"{'/'.join(parts[-2:])}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


class StepAnalysis(TorchDispatchMode):
    """The counting mode; ``analyze`` runs a step under it. With
    ``record_ops`` it keeps a row for every collective and for every
    other operation of at least ``ROW_BYTES`` (``launch/breakdown.py``
    reads them)."""

    def __init__(self, record_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.memory_bytes = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_count: dict[str, int] = defaultdict(int)
        self.kernel_calls: dict[str, int] = defaultdict(int)
        self.rows: list[dict] | None = [] if record_ops else None
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._kernel = 0
        self._lock = threading.RLock()

    # ---- live storages ----
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now until it is freed."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._storages:
                return
            n = _alloc(st.nbytes())
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key).atexit = False

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._storages.pop(key, 0)

    # ---- kernel entries (kernels.entry) ----
    def enter_kernel(self, name: str, flops: float, nbytes: float) -> None:
        with self._lock:
            if self._kernel == 0:
                self.flops += flops
                self.memory_bytes += nbytes
                self.kernel_calls[name] += 1
                self._row(name, name, [], nbytes)
            self._kernel += 1

    def exit_kernel(self) -> None:
        with self._lock:
            self._kernel -= 1

    def _row(self, kind: str, op: str, shapes: list, nbytes: float,
             **extra) -> None:
        if self.rows is not None and (kind in COLLECTIVES
                                      or nbytes >= ROW_BYTES):
            self.rows.append({"kind": kind, "op": op, "shapes": shapes,
                              "bytes": float(nbytes), "frame": _frame(),
                              **extra})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if torch._C._get_dispatch_mode(_FAKE) is not None or any(
                isinstance(t, FakeTensor) for t in ins):
            return out
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if self._kernel or func.is_view or func in _FREE_OPS:
            return out
        nbytes = _op_bytes(func, args, kwargs, outs)
        name = func._schema.name.split("::")[1]
        with self._lock:
            if name in _KIND:
                kind, vol, g = _collective_bytes(func, args, outs)
                self.coll_bytes[kind] += vol
                self.coll_count[kind] += 1
                self._row(kind, str(func), [list(t.shape) for t in ins],
                          vol, group=g)
            elif func.overloadpacket in flop_registry:
                self.flops += flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
            self.memory_bytes += nbytes
            if name not in _KIND:
                self._row("op", str(func), [list(t.shape) for t in ins],
                          nbytes)
        return out

    def result(self, argument_bytes: int) -> dict:
        return {"flops": self.flops,
                "memory_bytes": self.memory_bytes,
                "collective_bytes_by_kind": dict(self.coll_bytes),
                "collective_count_by_kind": dict(self.coll_count),
                "collective_total_bytes": sum(self.coll_bytes.values()),
                "kernel_calls": dict(self.kernel_calls),
                "argument_bytes": argument_bytes,
                "peak_bytes": self.peak}


def analyze(step, *args, record_ops: bool = False):
    """Run ``step(*args)`` once under the counting mode. -> (the step's
    result, the analysis: ``flops``, ``memory_bytes``,
    ``collective_bytes_by_kind``, ``collective_count_by_kind``,
    ``collective_total_bytes`` per device, ``kernel_calls`` by kernel,
    ``argument_bytes`` (the arguments' storages) and ``peak_bytes``, the
    high-water mark of live bytes, arguments included; with
    ``record_ops`` also ``ops``, the rows ``launch/breakdown.py`` reads:
    every collective, with its ``group`` size, and every other operation
    of ``ROW_BYTES`` or more)."""
    mode = StepAnalysis(record_ops=record_ops)
    for t in _tensors(args):
        mode.track(t)
    argument_bytes = mode.live
    kernels.listeners.append(mode)
    try:
        with mode:
            out = step(*args)
    finally:
        kernels.listeners.remove(mode)
    res = mode.result(argument_bytes)
    if record_ops:
        res["ops"] = mode.rows
    return out, res
