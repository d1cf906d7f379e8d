"""CUDA wrapper of the Hopper flash_gqa kernel (``csrc/flash_gqa.cu``, which
replaces the Pallas ``flash_attention_pallas`` of src/repro/kernels/
flash_gqa/flash_gqa.py; the source's note gives the design and its bound).

``flash_gqa`` takes the model layout as it is: q [B,Sq,H,D] and k/v at kv
head layout (k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv]), with a query-head ->
kv-head map instead of a repeat of k and v. Dv is D but for MLA's prefill
(q/k 192, v 128: ``HEAD_DIM_PAIRS``). Sq differs from Skv only in a call
with no mask (whisper's cross attention); a causal or windowed call has
Sq == Skv, as the Pallas kernel has no query offset.

The source has four bodies, and ``body`` says by shape which one a call
takes (``BODY_KERNELS`` names their CUDA functions): "wgmma" for bf16 at
``WGMMA_PAIRS`` (64, 64), (192, 128) and (256, 256) with any mask and Sq
(whisper's encoder and its cross attention, smollm-135m, MLA's prefill,
recurrentgemma-9b: wgmma with TMA, S computed once a tile), "split" for
any other call with no mask and Sq <= SPLIT_MAX_SQ (whisper's cross
attention at a decode step in f32: Skv split over about two blocks an
SM, then a merge in a fixed order), "mma" for bf16 at (16, 16), (32, 32)
and (128, 128) (``mma.sync``) and "fma" for f32 (f32 FMA, which the
2e-5 tolerance needs). ``split_plan`` picks the split body's split count
from the card's SM count, and ``wgmma_split_plan`` splits Skv in a wgmma
call with no mask for the blocks past its last full wave, where they
would leave most of the card idle (whisper's encoder, and its cross
attention, whose 24 blocks would hold 132 SMs); the wrapper decides
either plan, passes it to the source and allocates its f32 scratch
(``split_scratch_numel``, ``wgmma_scratch_numel``).
It checks device, dtype, shape, contiguity, alignment and the map,
allocates the output, launches on the current stream, checks the error
code, and counts one launch per call in ``launches`` (a split call's two
CUDA kernels are one launch). On the meta device
(the dry run) the launch is shape-only: the checks and the output. Where grad is needed
the call runs inside an autograd Function (``kernels/_autograd.py``) whose
backward is ``grads``: the model's own attention algorithm
(``models/attention.py:attention`` at the call's ``impl`` and ``chunk``)
differentiated chunk by chunk, as the reference's backward runs it.

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
from repro_torch.kernels._autograd import add_rows, index_select, kernel_call
from repro_torch.kernels.flash_gqa.ref import attention_ref
from repro_torch.models.attention import attention_vjp

launches = 0                      # flash_gqa() calls that launched the kernel
routed = 0                        # calls the model sent to the plain path
# the (q/k, v) head dims the kernel is built for: equal dims up to 128 and
# recurrentgemma-9b's 256, and MLA's prefill (deepseek-v2: 128 nope + 64
# rope, v 128)
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128),
                  (256, 256))
# the bodies of csrc/flash_gqa.cu (its note gives each one's design and
# bound) and the CUDA functions each launches; ``body`` picks one by shape
BODY_KERNELS = {
    # no mask, Sq <= 16, but bf16 at WGMMA_PAIRS
    "split": ("flash_gqa_split", "flash_gqa_merge"),
    # bf16 at WGMMA_PAIRS; the merge only where Skv is split
    "wgmma": ("flash_gqa_fwd_wgmma", "flash_gqa_merge_tiles"),
    "mma": ("flash_gqa_fwd_mma",),                     # bf16, other pairs
    "fma": ("flash_gqa_fwd",),                         # f32
}
# the head dims the wgmma body takes in bf16 (csrc launch<D, DV>) with the
# keys of its kv tiles (FwTile::BK) and its blocks an SM (FwTile::MINB, the
# launch bound) at each, and its query rows a block (FW_BQ). In a wgmma
# call with no mask the items past the last full wave of blocks are split
# over Skv where they fill at most half a wave, and flash_gqa_merge_tiles
# adds the splits (``wgmma_split_plan``)
WGMMA_KEYS = {(64, 64): 64, (192, 128): 128, (256, 256): 64}
WGMMA_BLOCKS_PER_SM = {(64, 64): 2, (192, 128): 1, (256, 256): 1}
WGMMA_PAIRS = tuple(WGMMA_KEYS)
WGMMA_ROWS = 128
# the split body (csrc FS_MAX_SQ, FS_MAX_H, FS_MAX_CH): query rows and
# heads a call may have, keys a split may hold (one a thread of the first
# pass), splits a call may have; a call has at most ceil(Skv /
# SPLIT_MIN_KEYS) splits
SPLIT_MAX_SQ, SPLIT_MAX_H, SPLIT_MAX_KEYS = 16, 256, 128
SPLIT_MAX_SPLITS, SPLIT_MIN_KEYS = 128, 32
_count_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_maps: dict[tuple, torch.Tensor] = {}     # kv maps already on a device
_sms: dict[torch.device, int] = {}        # SMs of each card


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_gqa")
    lib.flash_gqa.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, ctypes.c_float, _P, _I, _I,
                              _P]
    lib.flash_gqa.restype = _I
    lib.fa_error_string.argtypes = [_I]
    lib.fa_error_string.restype = ctypes.c_char_p
    lib.fa_last_launch.argtypes = []
    lib.fa_last_launch.restype = ctypes.c_char_p
    return lib


def last_launch() -> tuple[str, ...]:
    """The CUDA functions (without template arguments) that the source's
    dispatch launched for the last kernel call on this thread: one body's
    functions of ``BODY_KERNELS``."""
    return tuple(_lib().fa_last_launch().decode().split())


def body(q_shape, v_shape, dtype, *, causal: bool = True,
         window: int = 0) -> str:
    """The body of csrc/flash_gqa.cu that a call of these shapes takes (a
    key of ``BODY_KERNELS``): "wgmma" for bf16 at WGMMA_PAIRS with any
    mask and Sq (with no mask, its kv split: on an H100 it beat the split
    body at every Sq <= 16, ``launch/bench_flash.py``); else "split" with
    no mask, Sq <= SPLIT_MAX_SQ, H <= SPLIT_MAX_H and Skv within
    SPLIT_MAX_SPLITS splits of SPLIT_MAX_KEYS (whisper's cross attention
    at a decode step in f32); else by dtype, "mma" for bf16 at the other
    head dims and "fma" for f32."""
    B, Sq, H, D = q_shape
    if dtype == torch.bfloat16 and (D, v_shape[3]) in WGMMA_PAIRS:
        return "wgmma"
    if not causal and not window and Sq <= SPLIT_MAX_SQ \
            and H <= SPLIT_MAX_H \
            and v_shape[1] <= SPLIT_MAX_KEYS * SPLIT_MAX_SPLITS:
        return "split"
    return "mma" if dtype == torch.bfloat16 else "fma"


def split_plan(B: int, Skv: int, Hkv: int, sms: int) -> tuple[int, int]:
    """(n_split, keys a split) of the split body: about two first-pass
    blocks (b, kv head, split) on each of ``sms`` SMs, at most
    SPLIT_MAX_KEYS keys a split (one a thread), at most ceil(Skv /
    SPLIT_MIN_KEYS) splits and at most SPLIT_MAX_SPLITS (``body`` sends a
    longer Skv to the tiled bodies); every split holds ceil(Skv / n_split) keys but the
    last, which holds at least one. Whisper's decode (B 4, 6 kv heads, Skv
    1500) on 132 SMs: 12 splits of 125 keys, 288 blocks."""
    want = -(-2 * sms // (B * Hkv))
    n = min(max(want, -(-Skv // SPLIT_MAX_KEYS)), -(-Skv // SPLIT_MIN_KEYS),
            SPLIT_MAX_SPLITS)
    keys = -(-Skv // n)
    n = -(-Skv // keys)                 # no split left empty
    return n, -(-Skv // n)


def wgmma_split_plan(q_shape, v_shape, sms: int) -> tuple[int, int, int]:
    """(whole, n_split, keys a split) of the wgmma body in a call with no
    mask. Its items (b, h, query tile of WGMMA_ROWS rows) run in waves of
    WGMMA_BLOCKS_PER_SM blocks on each of ``sms`` SMs. Where the items
    past the last full wave fill at most half a wave, the first ``whole``
    items run whole and each of the others is split over Skv into
    n_split runs of whole kv tiles (WGMMA_KEYS at the call's head dims),
    about as many as fill one wave, none empty; else nothing is split
    (n_split 1). The source takes ``whole`` and n_split as given and
    splits the kv tiles as here, ceil(tiles / n_split) a split. On 132
    SMs: whisper's encoder (B 4, 1500 rows, 6 heads of 64) has 288 items,
    264 whole and 24 in 8 splits of 192 keys; its cross attention at the
    prefill (Sq 64) 24 items, all in 8 splits."""
    B, Sq, H, D = q_shape
    Skv, pair = v_shape[1], (D, v_shape[3])
    keys = WGMMA_KEYS[pair]
    items = B * H * -(-Sq // WGMMA_ROWS)
    slots = WGMMA_BLOCKS_PER_SM[pair] * sms
    tiles = -(-Skv // keys)
    rest = items % slots
    if not rest or 2 * rest > slots or tiles == 1:
        return items, 1, tiles * keys
    n = -(-tiles // -(-tiles // min(slots // rest, tiles)))
    return items - rest, n, -(-tiles // n) * keys


def wgmma_scratch_numel(q_shape, v_shape, sms: int) -> int:
    """f32 scratch of a wgmma call split by ``wgmma_split_plan``: each
    split item's WGMMA_ROWS rows' partial o [Dv], m and l for each
    split."""
    B, Sq, H, _ = q_shape
    whole, n_split, _ = wgmma_split_plan(q_shape, v_shape, sms)
    items = B * H * -(-Sq // WGMMA_ROWS)
    return (items - whole) * WGMMA_ROWS * n_split * (v_shape[3] + 2)


def split_scratch_numel(q_shape, v_shape, n_split: int) -> int:
    """f32 scratch of the split body: each query row's partial o [Dv], m
    and l for each split, B*Sq*H*n_split*(Dv + 2) floats."""
    B, Sq, H, _ = q_shape
    return B * Sq * H * n_split * (v_shape[3] + 2)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, kv_head=None, causal: bool = True
               ) -> tuple[int, ...]:
    """What the kernel takes, on any device: q [B,Sq,H,D], k [B,Skv,Hkv,D],
    v [B,Skv,Hkv,Dv], one floating dtype (f32 or bf16), Sq == Skv unless
    the call is neither causal nor windowed, (D, Dv) in HEAD_DIM_PAIRS,
    window >= 0, and a map of H kv heads in [0, Hkv) (``None``: h // (H /
    Hkv), which needs Hkv to divide H). Raises ValueError otherwise. -> the
    map as a tuple of ints."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q [B,Sq,H,D], k [B,Skv,Hkv,D] and v "
                         f"[B,Skv,Hkv,Dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Skv != S and (causal or window):
        raise ValueError(f"flash_gqa takes Sq == Skv in a causal or windowed "
                         f"call (no query offset); got Sq={S}, Skv={Skv}")
    if Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim")
    if (D, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_gqa takes (q/k, v) head dims "
                         f"{HEAD_DIM_PAIRS}; got ({D}, {v.shape[3]})")
    if S < 1 or Skv < 1 or B < 1 or Hkv < 1:
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


def takes(q_shape, k_shape, v_shape, *, causal: bool = True,
          window: int = 0) -> bool:
    """Whether the kernel takes q/k/v of these shapes with these masks: k
    and v alike but for their head dims, Sq == Skv unless the call is
    neither causal nor windowed, and (q/k, v) head dims in
    HEAD_DIM_PAIRS."""
    return (len(q_shape) == 4 and len(k_shape) == 4 and len(v_shape) == 4
            and tuple(k_shape[:3]) == tuple(v_shape[:3])
            and q_shape[0] == k_shape[0] and q_shape[3] == k_shape[3]
            and (q_shape[1] == k_shape[1] or not (causal or window))
            and (q_shape[3], v_shape[3]) in HEAD_DIM_PAIRS)


def count_routed():
    """Count one call that a model sent to the plain path because the
    kernel does not take its shapes (``takes``)."""
    global routed
    with _count_lock:
        routed += 1


def plain(q, k, v, *, causal: bool = True, window: int = 0, kv_head=None,
          scale: float | None = None):
    """The plain version on any device: ``attention_ref`` over k and v
    gathered to the query heads by the map (refusing what ``check_args``
    refuses)."""
    m = torch.tensor(check_args(q, k, v, window, kv_head, causal),
                     device=q.device)
    return attention_ref(q, index_select(k, 2, m), index_select(v, 2, m),
                         causal=causal, window=window, scale=scale)


def _map_on(m: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """The map as int32 on ``dev``, copied there once per distinct map."""
    key = (m, dev)
    t = _maps.get(key)
    if t is None:
        t = _maps[key] = torch.tensor(m, dtype=torch.int32, device=dev)
    return t


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, kv_head=None,
              impl: str = "chunked", chunk: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q [B,Sq,H,D], k [B,Skv,Hkv,D], v [B,Skv,Hkv,Dv], contiguous on one
    CUDA device, f32 or bf16 alike (Sq == Skv unless neither ``causal``
    nor ``window``); ``kv_head``: query head -> kv head (host ints, default
    h // (H / Hkv)). -> o [B,Sq,H,Dv] in q's dtype: softmax(q.k * scale)
    v (``scale`` None: 1/sqrt(D)) over the keys at or before each query
    (``causal``) and within the last ``window`` positions (``window`` >
    0). Differentiable in q, k and v through ``grads`` at ``impl`` and
    ``chunk`` (the model's ``attn_impl`` and ``attn_chunk``; ``chunk``
    None: one chunk of Sq queries)."""
    kw = {"causal": causal, "window": window, "kv_head": kv_head,
          "scale": scale}
    launch = _shape_only if q.device.type == "meta" else _launch

    def vjp(saved, gouts, need):
        return grads(*saved, gouts[0], impl=impl, chunk=chunk, **kw)
    return kernel_call(lambda *t: (launch(*t, **kw),),
                       lambda *t: (plain(*t, **kw),), q, k, v, vjp=vjp)[0]


def grads(q, k, v, go, *, causal: bool = True, window: int = 0,
          kv_head=None, impl: str = "chunked", chunk: int | None = None,
          scale: float | None = None):
    """The backward of a ``flash_gqa`` call under the cotangent ``go``
    [B,Sq,H,Dv] (None: no gradient) -> (dq, dk, dv): ``attention_vjp`` of
    the model's algorithm at ``impl`` and ``chunk`` over k and v gathered
    to the query heads by the map, the gathered gradients added back into
    the kv heads in a fixed order (``_autograd.add_rows``)."""
    if go is None:
        return None, None, None
    m = check_args(q, k, v, window, kv_head, causal)
    idx = torch.tensor(m, device=q.device)
    dq, dk, dv = attention_vjp(
        q, k.index_select(2, idx), v.index_select(2, idx), go, impl=impl,
        causal=causal, window=window, chunk=chunk or q.shape[1],
        scale=scale)
    Hkv = k.shape[2]
    return dq, add_rows(dk, 2, idx, Hkv), add_rows(dv, 2, idx, Hkv)


def _shape_only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int, kv_head, scale=None
                ) -> torch.Tensor:
    """The launch on the meta device: the checks and the output a launch
    allocates, nothing computed and nothing counted."""
    check_args(q, k, v, window, kv_head, causal)
    return q.new_empty((*q.shape[:3], v.shape[3]))


def _sm_count(dev: torch.device) -> int:
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int, kv_head, scale: float | None = None,
            which: str | None = None) -> torch.Tensor:
    """One launch of the kernel (``flash_gqa`` without autograd), softmax
    scale ``scale`` (None: 1/sqrt(D)): the body
    ``body`` names, or ``which`` (to time two bodies at one shape: "split"
    or the tiled body of the dtype and head dims, the wgmma body with its
    kv split)."""
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
    m = check_args(q, k, v, window, kv_head, causal)
    B, S, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    lib = _lib()
    kvh = _map_on(m, dev)
    o = q.new_empty((B, S, H, Dv))
    # the body for the source (its launch): n_split > 0 with whole < 0
    # the split body, n_split > 1 with whole >= 0 the wgmma body split
    # from item ``whole`` on, n_split 0 the tiled body unsplit
    n_split, whole, numel = 0, 0, 0
    which = which or body(q.shape, v.shape, q.dtype, causal=causal,
                          window=window)
    if which == "split":
        n_split, whole = split_plan(B, Skv, Hkv, _sm_count(dev))[0], -1
        numel = split_scratch_numel(q.shape, v.shape, n_split)
    elif which == "wgmma" and not causal and not window:
        w, n, _ = wgmma_split_plan(q.shape, v.shape, _sm_count(dev))
        if n > 1:
            n_split, whole = n, w
            numel = wgmma_scratch_numel(q.shape, v.shape, _sm_count(dev))
    scratch = torch.empty(numel, dtype=torch.float32,
                          device=dev) if numel else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_gqa(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), kvh.data_ptr(), o.data_ptr(), B, S,
                            Skv, H, Hkv, D, Dv, int(causal), window,
                            1.0 / math.sqrt(D) if scale is None else scale,
                            None if scratch is None else scratch.data_ptr(),
                            n_split, whole, stream)
    if err:
        raise RuntimeError(f"flash_gqa: CUDA error {err}: "
                           f"{lib.fa_error_string(err).decode()}")
    with _count_lock:
        launches += 1
    return o
