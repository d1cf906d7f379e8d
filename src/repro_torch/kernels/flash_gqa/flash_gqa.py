"""CUDA wrapper of the Hopper flash_gqa kernel (``csrc/flash_gqa.cu``, which
replaces the Pallas ``flash_attention_pallas`` of src/repro/kernels/
flash_gqa/flash_gqa.py; the source's note gives the design and its bound).

``flash_gqa`` takes the model layout as it is: q [B,S,H,D] and k/v at kv
head layout [B,S,Hkv,D], with a query-head -> kv-head map instead of a
repeat of k and v. bf16 runs on the tensor cores, f32 on the f32 pipes.
It checks device, dtype, shape, contiguity, alignment and the map,
allocates the output, launches on the current stream, checks the error
code, and counts one launch per call in ``launches``. Where grad is needed
the call runs inside an autograd Function whose backward is the plain
version's (``kernels/_autograd.py``).

``takes`` says by shape alone whether the kernel takes a call; a model
sends the calls it does not take to the plain path and counts them with
``count_routed`` in ``routed``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._autograd import kernel_call
from repro_torch.kernels.flash_gqa.ref import attention_ref

launches = 0                      # flash_gqa() calls that launched the kernel
routed = 0                        # calls the model sent to the plain path
HEAD_DIMS = (16, 32, 64, 128)     # the head dims the kernel takes
_count_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_maps: dict[tuple, torch.Tensor] = {}     # kv maps already on a device


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_gqa")
    lib.flash_gqa.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, ctypes.c_float, _P]
    lib.flash_gqa.restype = _I
    lib.fa_error_string.argtypes = [_I]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, kv_head=None) -> tuple[int, ...]:
    """What the kernel takes, on any device: q [B,S,H,D], k/v [B,S,Hkv,D]
    alike, one floating dtype (f32 or bf16), Sq == Skv, D in HEAD_DIMS,
    window >= 0, and a map of H kv heads in [0, Hkv) (``None``: h // (H /
    Hkv), which needs Hkv to divide H). Raises ValueError otherwise.
    -> the map as a tuple of ints."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,S,H,D] and k/v [B,S,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Skv != S:
        raise ValueError(f"flash_gqa takes Sq == Skv (no query offset); got "
                         f"Sq={S}, Skv={Skv}")
    if Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_gqa takes head dims {HEAD_DIMS}; got {D}")
    if S < 1 or B < 1 or Hkv < 1:
        raise ValueError(f"empty input {tuple(q.shape)}, {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must be float32 or bfloat16 alike; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if kv_head is None:
        if H % Hkv:
            raise ValueError(f"{Hkv} kv heads do not divide {H} query heads; "
                             "pass kv_head")
        return tuple(h // (H // Hkv) for h in range(H))
    m = tuple(int(x) for x in kv_head)
    if len(m) != H or any(x < 0 or x >= Hkv for x in m):
        raise ValueError(f"kv_head must map {H} query heads into [0, {Hkv}); "
                         f"got {m}")
    return m


def takes(q_shape, k_shape, v_shape) -> bool:
    """Whether the kernel takes q/k/v of these shapes: k and v alike
    (so v's head dim is k's), Sq == Skv and a head dim in HEAD_DIMS."""
    return (len(q_shape) == 4 and tuple(k_shape) == tuple(v_shape)
            and len(k_shape) == 4 and q_shape[1] == k_shape[1]
            and q_shape[3] == k_shape[3] and q_shape[3] in HEAD_DIMS)


def count_routed():
    """Count one call that a model sent to the plain path because the
    kernel does not take its shapes (``takes``)."""
    global routed
    with _count_lock:
        routed += 1


def plain(q, k, v, *, causal: bool = True, window: int = 0, kv_head=None):
    """The plain version on any device: ``attention_ref`` over k and v
    gathered to the query heads by the map (refusing what ``check_args``
    refuses)."""
    m = torch.tensor(check_args(q, k, v, window, kv_head), device=q.device)
    return attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)


def _map_on(m: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """The map as int32 on ``dev``, copied there once per distinct map."""
    key = (m, dev)
    t = _maps.get(key)
    if t is None:
        t = _maps[key] = torch.tensor(m, dtype=torch.int32, device=dev)
    return t


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_head=None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,S,Hkv,D], contiguous on one CUDA device, f32 or
    bf16 alike; ``kv_head``: query head -> kv head (host ints, default h //
    (H / Hkv)). -> o [B,S,H,D] in q's dtype: softmax(q.k / sqrt(D)) v over
    the keys at or before each query (``causal``) and within the last
    ``window`` positions (``window`` > 0). Differentiable in q, k and v
    through the plain version."""
    kw = {"causal": causal, "window": window, "kv_head": kv_head}
    return kernel_call(lambda *t: (_launch(*t, **kw),),
                       lambda *t: (plain(*t, **kw),), q, k, v)[0]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, kv_head) -> torch.Tensor:
    """One launch of the kernel (``flash_gqa`` without autograd)."""
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_gqa kernel needs CUDA tensors, got {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}; got "
                             f"{t.device}, contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the kernel "
                             "loads rows 16 bytes at a time)")
    m = check_args(q, k, v, window, kv_head)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    lib = _lib()
    kvh = _map_on(m, dev)
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_gqa(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), kvh.data_ptr(), o.data_ptr(), B, S,
                            H, Hkv, D, int(causal), window,
                            1.0 / math.sqrt(D), stream)
    if err:
        raise RuntimeError(f"flash_gqa: CUDA error {err}: "
                           f"{lib.fa_error_string(err).decode()}")
    with _count_lock:
        launches += 1
    return o
