"""CUDA wrapper of the Hopper ssd_scan kernel (``csrc/ssd_scan.cu``, which
replaces the Pallas ``ssd_pallas`` of src/repro/kernels/ssd_scan/
ssd_scan.py; the source's note gives the design and its bound).

``ssd_scan`` takes the model layout as it is: no head repeat of B and C,
x*dt and dt*A are folded inside the kernel. It checks device, dtype, shape
and contiguity, allocates both outputs and the f32 scratch of the
chunk-parallel split (C.B^T per chunk and group, each chunk's state, each
chunk's decay), runs the four CUDA kernels of one call on the current
stream, checks the error code, and counts one launch per call in
``launches``. Where grad is needed the call runs inside an autograd
Function whose backward is the plain version's (``kernels/_autograd.py``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

launches = 0                      # ssd_scan() calls that launched the kernels
_count_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P]
    lib.ssd_scan.restype = _I
    lib.ssd_error_string.argtypes = [_I]
    lib.ssd_error_string.restype = ctypes.c_char_p
    lib.ssd_max_chunk.restype = _I
    lib.ssd_max_state.restype = _I
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """x [B,S,H,P], dt [B,S,H] f32 (post-softplus), A [H] f32,
    Bm/Cm [B,S,G,N], all contiguous on one CUDA device; x, Bm and Cm f32 or
    bf16 alike. -> (y [B,S,H,P] in x's dtype, state [B,H,P,N] f32), with
    chunks of min(chunk, S) rows. Differentiable in every input through
    the plain version (``ssd_chunked``)."""
    return kernel_call(lambda *t: _launch(*t, chunk=chunk),
                       lambda *t: ssd_chunked(*t, min(chunk, t[0].shape[1])),
                       x, dt, A, Bm, Cm)


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """One call of the four kernels (``ssd_scan`` without autograd)."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got {dev}")
    ts = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    for name, t in ts.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}; got "
                             f"{t.device}, contiguous={t.is_contiguous()}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4:
        raise ValueError("want x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm "
                         f"[B,S,G,N]; got {[tuple(t.shape) for t in ts.values()]}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bm.shape) != (B, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shapes disagree: {[tuple(t.shape) for t in ts.values()]}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm, Cm must be float32 or bfloat16 alike; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32; got {dt.dtype}, "
                         f"{A.dtype}")
    lib = _lib()
    Q = min(chunk, S)
    if Q < 1 or S % Q or H % G or Q > lib.ssd_max_chunk() \
            or N > lib.ssd_max_state():
        raise ValueError(
            f"ssd_scan takes chunks of at most {lib.ssd_max_chunk()} rows "
            f"that divide S, a state of at most {lib.ssd_max_state()} and "
            f"groups that divide the heads; got S={S} chunk={Q} N={N} "
            f"H={H} G={G}")
    nc = S // Q
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    f32 = {"dtype": torch.float32, "device": dev}
    cb = torch.empty((B, nc, G, Q, Q), **f32)          # C.B^T, lower tiles
    states = torch.empty((B, nc, H, P, N), **f32)      # per-chunk states
    csl = torch.empty((B, H, nc), **f32)               # cumsum(dt*A) totals
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
                           A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                           y.data_ptr(), state.data_ptr(), cb.data_ptr(),
                           states.data_ptr(), csl.data_ptr(), B, S, H, P, G,
                           N, Q, stream)
    if err:
        raise RuntimeError(f"ssd_scan: CUDA error {err}: "
                           f"{lib.ssd_error_string(err).decode()}")
    with _count_lock:
        launches += 1
    return y, state
