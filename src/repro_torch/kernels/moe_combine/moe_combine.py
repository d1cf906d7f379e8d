"""CUDA wrapper of the Hopper moe_combine kernel (``csrc/moe_combine.cu``,
which replaces no TPU kernel; the source's note gives the function, its
order of sums, its bound and its design).

``combine`` checks device, dtype, shape and contiguity, allocates the
output, launches the kernel on the current stream, checks the error code
and counts one launch per call in ``launches``. Where grad is needed the
call runs inside an autograd Function whose backward recomputes the plain
version (``ref.combine``) and differentiates it (``kernels/_autograd.py``),
so gradients keep its fixed-order adds. On the meta device (the dry run) a
call is shape-only: it allocates the output and computes nothing.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels.moe_combine import ref

launches = 0                      # combine() calls that launched the kernel
MAX_K = 32                        # MC_MAX_K: a token's entries
_count_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    """The built library with its signatures, loaded once."""
    global _loaded
    if _loaded is None:
        lib = _build.load("moe_combine")
        lib.moe_combine.argtypes = [_I, _P, _P, _P, _P, _P, ctypes.c_int64,
                                    _I, _I, _I, _P]
        lib.moe_combine.restype = _I
        lib.moe_combine_error_string.argtypes = [_I]
        lib.moe_combine_error_string.restype = ctypes.c_char_p
        if lib.moe_combine_max_k() != MAX_K:
            raise RuntimeError(f"moe_combine_max_k() is "
                               f"{lib.moe_combine_max_k()}, the wrapper has "
                               f"{MAX_K}")
        _loaded = lib
    return _loaded


def combine(eout: torch.Tensor, ids: torch.Tensor, slots: torch.Tensor,
            weights: torch.Tensor, C: int, S: int, k: int) -> torch.Tensor:
    """eout [E, B*C, d] (f32 or bf16), ids and slots [B*S*k] int32 as
    ``models/moe.dispatch`` returns them, weights [B*S, k] in eout's
    dtype, all contiguous on one CUDA device. -> out [B, S, d]: each kept
    entry's row ids·C + slot of eout seen flat, times its weight, a
    token's entries summed in order (``ref.combine_in_order``).
    Differentiable in eout and weights through ``ref.combine``."""
    launch = _shape_only if eout.device.type == "meta" else _launch
    (out,) = kernel_call(
        lambda *t: (launch(*t, C=C, S=S, k=k),),
        lambda *t: (ref.combine(*t, C, S, k),),
        eout, ids, slots, weights)
    return out


def _shape_only(eout, ids, slots, weights, *, C: int, S: int, k: int):
    """The call on the meta device: the output a launch allocates,
    nothing computed and nothing counted."""
    return eout.new_empty((ids.shape[0] // (S * k), S, eout.shape[-1]))


def _launch(eout: torch.Tensor, ids: torch.Tensor, slots: torch.Tensor,
            weights: torch.Tensor, *, C: int, S: int, k: int):
    """One launch of the kernel (``combine`` without autograd)."""
    global launches
    dev = eout.device
    if dev.type != "cuda":
        raise ValueError(f"moe_combine kernel needs CUDA tensors, got {dev}")
    ts = {"eout": eout, "ids": ids, "slots": slots, "weights": weights}
    for name, t in ts.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}; got "
                             f"{t.device}, contiguous={t.is_contiguous()}")
    if eout.dtype not in _DTYPES or weights.dtype != eout.dtype:
        raise ValueError(f"eout and weights must be float32 or bfloat16 "
                         f"alike; got {eout.dtype}, {weights.dtype}")
    if ids.dtype != torch.int32 or slots.dtype != torch.int32:
        raise ValueError(f"ids and slots must be int32; got {ids.dtype}, "
                         f"{slots.dtype}")
    if not 1 <= k <= MAX_K or C < 1 or S < 1:
        raise ValueError(f"moe_combine takes 1 to {MAX_K} entries a token "
                         f"and C, S >= 1; got k={k} C={C} S={S}")
    n = ids.shape[0]
    d = eout.shape[-1]
    if eout.dim() != 3 or eout.shape[1] % C or ids.dim() != 1 \
            or slots.shape != ids.shape or n % (S * k) \
            or tuple(weights.shape) != (n // k, k):
        raise ValueError(
            f"want eout [E, B*C, d], ids and slots [B*S*k], weights "
            f"[B*S, k] with C={C} S={S} k={k}; got "
            f"{[tuple(t.shape) for t in ts.values()]}")
    if (d * eout.element_size()) % 16 or eout.data_ptr() % 16:
        raise ValueError(f"the kernel moves rows in 16-byte vectors: eout's "
                         f"rows ({d} x {eout.element_size()} bytes) and its "
                         f"start must be 16-byte aligned")
    out = eout.new_empty((n // (S * k), S, d))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.moe_combine(_DTYPES[eout.dtype], eout.data_ptr(),
                              ids.data_ptr(), slots.data_ptr(),
                              weights.data_ptr(), out.data_ptr(), n // k, k,
                              d, C, stream)
    if err:
        raise RuntimeError(f"moe_combine: CUDA error {err}: "
                           f"{lib.moe_combine_error_string(err).decode()}")
    with _count_lock:
        launches += 1
    return out
