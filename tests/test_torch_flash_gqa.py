"""The port's flash_gqa entry point (``kernels/flash_gqa/ops.flash_gqa``)
on the CPU against the JAX package: its Pallas kernel in interpret mode,
its materialized oracle and the model's chunked attention, at the Pallas
kernel test's CASES in f32 and bf16, with the padded-head kv maps of
smollm-135m and qwen2-vl-7b, and with what the kernel refuses; and the
bf16 CUDA body's precision plan (bf16 products, P rounded to bf16 before
P.V) repeated on the CPU against ``attention_ref`` at the card tolerance.

On the CPU ``ops.flash_gqa`` runs the port's plain ``attention_ref``; the
CUDA kernel is held against that same function on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs are numpy from a seed.
Tolerances are the reference test's: 2e-5 in f32 (sums in another order),
2e-2 in bf16 (each side rounds its f32 result to bf16 once)."""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import registry as jax_registry  # noqa: E402
from repro.kernels.flash_gqa.ops import flash_gqa as jax_flash  # noqa: E402
from repro.kernels.flash_gqa.ref import attention_ref as jax_ref  # noqa
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as K  # noqa: E402
from repro_torch.kernels.flash_gqa import ops  # noqa: E402
from repro_torch.kernels.flash_gqa.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window  (tests/test_kernel_flash_gqa.py)
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 3, 1, 128, True, 0),
    (2, 128, 128, 2, 2, 32, True, 0),
    (1, 384, 384, 2, 1, 64, True, 128),
    (1, 200, 200, 2, 2, 64, True, 0),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Skv, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _pair(arrs, jdt, tdt):
    """numpy arrays as JAX arrays and as CPU tensors of one dtype."""
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window", CASES)
def test_matches_pallas_kernel_and_oracle(B, Sq, Skv, H, Hkv, D, causal,
                                          window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    (qj, kj, vj), (qt, kt, vt) = _pair(
        _inputs(B, Sq, Skv, H, Hkv, D, Sq + H), jdt, tdt)
    before = K.launches
    got = ops.flash_gqa(qt, kt, vt, causal=causal, window=window)
    assert K.launches == before                 # CPU: the plain path
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, H, D)
    pallas = jax_flash(qj, kj, vj, causal=causal, window=window,
                       use_pallas=True, interpret=True)
    rep = H // Hkv
    oracle = jax_ref(qj, jnp.repeat(kj, rep, 2), jnp.repeat(vj, rep, 2),
                     causal=causal, window=window)
    _close(got, pallas, tol)
    _close(got, oracle, tol)


def test_matches_model_chunked_attention():
    """As tests/test_kernel_flash_gqa.py: the kernel's function equals the
    model's chunked attention, the reference's and the port's."""
    q, k, v = _inputs(2, 256, 256, 4, 4, 64, 0)
    (qj, kj, vj), (qt, kt, vt) = _pair((q, k, v), jnp.float32,
                                       torch.float32)
    got = ops.flash_gqa(qt, kt, vt, causal=True)
    _close(got, JA.chunked_attention(qj, kj, vj, causal=True, chunk=64),
           2e-5)
    _close(got, TA.chunked_attention(qt, kt, vt, causal=True, chunk=64)
           .numpy(), 2e-5)


@pytest.mark.parametrize("arch", sorted(
    a for a in jax_registry() if jax_get_config(a).attn_kind == "gqa"))
def test_kv_map_equals_reference(arch):
    cfg = jax_get_config(arch)
    np.testing.assert_array_equal(TT._kv_map(get_config(arch)),
                                  JT._kv_map(cfg))
    assert (TT._head_mask(get_config(arch)) is None) == \
        (JT._head_mask(cfg) is None)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-7b"])
def test_padded_head_map_matches_reference(arch, dtype):
    """smollm-135m pads 9/3 heads to 16/4 and qwen2-vl-7b 28/4 to 32/4:
    padded q heads read kv head 0, so the map is no h // rep. The port
    reads k/v through it; the reference gathers k/v with its own map."""
    jdt, tdt, tol = DTYPES[dtype]
    kvmap = JT._kv_map(jax_get_config(arch))
    Hq, Hkv = JT._heads(jax_get_config(arch))
    q, k, v = _inputs(1, 96, 96, Hq, Hkv, 64, Hq)
    (qj, kj, vj), (qt, kt, vt) = _pair((q, k, v), jdt, tdt)
    got = ops.flash_gqa(qt, kt, vt, causal=True, kv_head=kvmap)
    want = jax_ref(qj, jnp.take(kj, kvmap, 2), jnp.take(vj, kvmap, 2),
                   causal=True)
    _close(got, want, tol)
    assert kvmap.tolist() != [h // (Hq // Hkv) for h in range(Hq)]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 16)])
def test_bidirectional_and_window(causal, window):
    q, k, v = _inputs(2, 80, 80, 4, 2, 32, 7)
    (qj, kj, vj), (qt, kt, vt) = _pair((q, k, v), jnp.float32,
                                       torch.float32)
    got = ops.flash_gqa(qt, kt, vt, causal=causal, window=window)
    want = jax_ref(qj, jnp.repeat(kj, 2, 2), jnp.repeat(vj, 2, 2),
                   causal=causal, window=window)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (64, 128, True, 0), (1, 96, True, 0), (48, 80, True, 24),
    (64, 128, False, 0)])
def test_oracle_aligns_queries_to_the_end(Sq, Skv, causal, window):
    """Sq < Skv: ``attention_ref`` puts query i at kv position i + Skv - Sq
    (ref.py:20-22). The reference's Pallas kernel has no query offset
    (flash_gqa.py:46-47), and neither has the port's CUDA kernel, which
    refuses Sq != Skv in a causal or windowed call; so these cases hold
    the port's oracle against the reference's oracle only."""
    q, k, v = _inputs(2, Sq, Skv, 4, 4, 32, Sq)
    (qj, kj, vj), (qt, kt, vt) = _pair((q, k, v), jnp.float32,
                                       torch.float32)
    _close(attention_ref(qt, kt, vt, causal=causal, window=window),
           jax_ref(qj, kj, vj, causal=causal, window=window), 2e-5)


def test_refuses_what_the_kernel_does_not_take():
    """The CPU path refuses what the card's kernel refuses, with the same
    ValueError, so a CPU run shows what the card would not take."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 4, 2, 64, 3))
    with pytest.raises(ValueError, match="Sq == Skv"):
        ops.flash_gqa(q[:, :32], k, v)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_gqa(*(torch.zeros(1, 8, 2, 320) for _ in range(3)))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_gqa(*(torch.zeros(1, 8, 2, 48) for _ in range(3)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_gqa(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="kv_head"):
        ops.flash_gqa(q, k, v, kv_head=[0, 1, 2, 0])
    with pytest.raises(ValueError, match="kv_head"):
        ops.flash_gqa(q, k, v, kv_head=[0, 1])
    with pytest.raises(ValueError, match="window"):
        ops.flash_gqa(q, k, v, window=-1)


@pytest.mark.parametrize("D,Dv,takes", [
    (16, 16, True), (64, 64, True), (128, 128, True), (192, 128, True),
    (256, 256, True), (24, 24, False), (320, 320, False), (24, 16, False),
    (64, 32, False), (192, 192, False), (128, 192, False)])
def test_kernel_takes_by_shape(D, Dv, takes):
    """``takes``, which the model's attention asks before it sends a CUDA
    call to the kernel, says yes exactly where ``check_args`` does: head
    dims 16-128 and recurrentgemma's 256 with v's head dim equal to k's,
    and MLA's q/k 192 with v 128. Head dim 24 and the other v/k pairs go
    to the plain path and are counted there."""
    q, k, v = (torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 2, D),
               torch.zeros(1, 8, 2, Dv))
    assert K.takes(q.shape, k.shape, v.shape) is takes
    if takes:
        K.check_args(q, k, v, 0)
    else:
        with pytest.raises(ValueError):
            K.check_args(q, k, v, 0)


@pytest.mark.parametrize("D,Dv", [(24, 24), (24, 16), (64, 32)])
def test_attend_plain_path_takes_what_the_kernel_does_not(D, Dv):
    """The plain path that the routed calls take computes attention for
    those shapes: held against the reference's materialized oracle."""
    cfg = smoke_config("glm4-9b").replace(head_dim=D)
    rng = np.random.default_rng(D + Dv)
    H, Hkv = TT._heads(cfg)
    q = rng.standard_normal((2, 48, H, D)).astype(np.float32)
    k = rng.standard_normal((2, 48, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, 48, Hkv, Dv)).astype(np.float32)
    got = TT._attend(cfg, *(torch.from_numpy(a) for a in (q, k, v)),
                     causal=True, window=0)
    idx = np.asarray(TT._kv_index(cfg, "cpu"))
    _close(got, jax_ref(jnp.asarray(q), jnp.asarray(k[:, :, idx]),
                        jnp.asarray(v[:, :, idx]), causal=True), 2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 2, 64, 4))
    before = K.launches
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_gqa(q, k, v)
    assert K.launches == before


def _mma_plan(q, k, v, *, causal, window, kv_head):
    """The roundings of the bf16 tensor-core body (flash_gqa.cu,
    flash_gqa_fwd_mma), in PyTorch on the CPU: per kv tile of 64 keys, q.k
    of bf16 values with f32 sums, scaled into the log2 domain; the online
    softmax in f32 with l summed from the f32 probabilities; P rounded to
    bf16 before P.V (f32 sums); o = acc / max(l, 1e-30), rounded to bf16.
    A test helper, not the port's plain version."""
    B, S, H, D = q.shape
    m_idx = torch.tensor(kv_head)
    qf = q.float().transpose(1, 2)                          # [B,H,S,D]
    kf = k.index_select(2, m_idx).float().transpose(1, 2)
    vf = v.index_select(2, m_idx).float().transpose(1, 2)   # [B,H,S,Dv]
    c = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, v.shape[-1]))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        kpos = torch.arange(k0, min(k0 + 64, S))[None, :]
        s = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c
        ok = torch.ones((S, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m_new == float("-inf"), 1.0,
                            torch.exp2(m - m_new))
        p = torch.where(s == float("-inf"), 0.0, torch.exp2(s - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + 64]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


PLAN_CASES = [
    # B, S, H, Hkv, D, causal, window, kv_head
    *[(B, Sq, H, Hkv, D, causal, window, None)
      for B, Sq, _, H, Hkv, D, causal, window in CASES],
    (2, 72, 4, 2, 16, True, 0, None),
    (1, 200, 4, 2, 64, False, 48, None),
    (2, 130, 4, 2, 64, True, 24, None),
    (2, 130, 16, 4, 64, True, 0, (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0,
                                  0, 0)),
    (4, 512, 32, 2, 128, True, 0, None),        # glm4-9b's prefill
]


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,kv_head", PLAN_CASES)
def test_bf16_mma_plan_meets_card_tolerance(B, S, H, Hkv, D, causal, window,
                                            kv_head):
    """The bf16 body's precision plan, repeated on the CPU, stays within
    the card's bf16 tolerance (2e-2) of attention_ref at every case and at
    the dense serve path's shape."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(B, S, S, H, Hkv, D, S + H))
    kv_head = kv_head or tuple(h // (H // Hkv) for h in range(H))
    got = _mma_plan(q, k, v, causal=causal, window=window, kv_head=kv_head)
    m = torch.tensor(kv_head)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# MLA's prefill (deepseek-v2): q/k head dim 192 (128 nope + 64 rope), v
# 128, 16 heads over 16 kv heads; the smoke config's 24 / 16 pair, which
# the kernel does not take, goes through the plain path
MLA_CASES = [
    # B, S, H, D, Dv
    (2, 130, 4, 192, 128),
    (1, 64, 16, 192, 128),
    (2, 48, 4, 24, 16),
]


def _mla_inputs(B, S, H, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, H, Dv)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,H,D,Dv", MLA_CASES)
def test_v_head_dim_unlike_k_matches_reference(B, S, H, D, Dv, dtype):
    """attention_ref with v's head dim unlike q's and k's, scaled by
    1/sqrt(D), against the reference's materialized oracle and the
    model's chunked attention, which MLA's prefill calls
    (src/repro/models/transformer.py:250-251); where the kernel takes the
    pair, ops.flash_gqa's CPU path gives the same. (The Pallas kernel
    cannot take the pair: its wrapper pads v with q's padding.)"""
    jdt, tdt, tol = DTYPES[dtype]
    (qj, kj, vj), (qt, kt, vt) = _pair(_mla_inputs(B, S, H, D, Dv, S + D),
                                       jdt, tdt)
    got = attention_ref(qt, kt, vt, causal=True)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, Dv)
    _close(got, jax_ref(qj, kj, vj, causal=True), tol)
    _close(got, JA.attention(qj, kj, vj, causal=True, chunk=64), tol)
    if K.takes(qt.shape, kt.shape, vt.shape):
        _close(ops.flash_gqa(qt, kt, vt, causal=True), np.asarray(
            got.float()), tol)
    else:
        with pytest.raises(ValueError, match="head dims"):
            ops.flash_gqa(qt, kt, vt, causal=True)


@pytest.mark.parametrize("B,S,H,D,Dv", [(4, 512, 16, 192, 128),
                                        (2, 130, 4, 192, 128)],
                         ids=["deepseek-prefill", "ragged"])
def test_bf16_mma_plan_meets_card_tolerance_for_mla(B, S, H, D, Dv):
    """The bf16 body's precision plan at MLA's head dims, at
    deepseek-v2-lite's prefill shape and a ragged one, within the card's
    bf16 tolerance (2e-2) of attention_ref."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _mla_inputs(B, S, H, D, Dv, S + H))
    kv_head = tuple(range(H))
    got = _mma_plan(q, k, v, causal=True, window=0, kv_head=kv_head)
    want = attention_ref(q, k, v, causal=True)
    assert got.shape == (B, S, H, Dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# whisper's cross attention (the decoder's queries against the encoder's
# frames, no mask) and recurrentgemma-9b's head dim 256 (16 heads over 1,
# causal, window 2048)
@pytest.mark.parametrize("Sq,Skv,causal,window,takes", [
    (64, 1500, False, 0, True), (1, 1500, False, 0, True),
    (1500, 64, False, 0, True), (64, 128, True, 0, False),
    (64, 128, False, 16, False), (64, 128, True, 16, False),
    (128, 128, True, 0, True), (128, 128, False, 16, True)])
def test_kernel_takes_sq_unlike_skv_only_with_no_mask(Sq, Skv, causal,
                                                      window, takes):
    """A call with Sq != Skv has no query offset in the kernel, so it takes
    one only with no mask (cross attention); ``takes`` and ``check_args``
    agree, and ``check_args`` names Sq == Skv when it refuses."""
    q, k, v = (torch.zeros(2, Sq, 6, 64), torch.zeros(2, Skv, 6, 64),
               torch.zeros(2, Skv, 6, 64))
    assert K.takes(q.shape, k.shape, v.shape, causal=causal,
                   window=window) is takes
    if takes:
        K.check_args(q, k, v, window, causal=causal)
    else:
        with pytest.raises(ValueError, match="Sq == Skv"):
            K.check_args(q, k, v, window, causal=causal)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv", [
    (2, 64, 256, 6, 6), (2, 1, 128, 6, 6), (1, 100, 384, 4, 2)])
def test_cross_attention_matches_pallas_kernel(B, Sq, Skv, H, Hkv, dtype):
    """No mask, Sq != Skv, at shapes the reference's Pallas wrapper takes
    (Skv a multiple of its 128-row block, ops.py:42): the port's CPU path
    against the Pallas kernel in interpret mode and the materialized
    oracle."""
    jdt, tdt, tol = DTYPES[dtype]
    (qj, kj, vj), (qt, kt, vt) = _pair(
        _inputs(B, Sq, Skv, H, Hkv, 64, Sq + Skv), jdt, tdt)
    got = ops.flash_gqa(qt, kt, vt, causal=False)
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, H, 64)
    rep = H // Hkv
    pallas = jax_flash(qj, kj, vj, causal=False, use_pallas=True,
                       interpret=True)
    oracle = jax_ref(qj, jnp.repeat(kj, rep, 2), jnp.repeat(vj, rep, 2),
                     causal=False)
    _close(got, pallas, tol)
    _close(got, oracle, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv", [(2, 64, 1500), (2, 1, 1500),
                                      (1, 1500, 1500)],
                         ids=["cross-prefill", "cross-decode", "encoder"])
def test_whisper_shapes_match_reference_oracle(B, Sq, Skv, dtype):
    """whisper-tiny's shapes (6 heads of 64; 1500 frames, no multiple of
    the Pallas wrapper's block, whose padding it refuses without a mask):
    the port's CPU path against the reference's materialized oracle."""
    jdt, tdt, tol = DTYPES[dtype]
    (qj, kj, vj), (qt, kt, vt) = _pair(_inputs(B, Sq, Skv, 6, 6, 64, Sq),
                                       jdt, tdt)
    _close(ops.flash_gqa(qt, kt, vt, causal=False),
           jax_ref(qj, kj, vj, causal=False), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,window", [(1, 256, 0), (1, 384, 128),
                                        (1, 200, 0)],
                         ids=["causal", "window", "ragged"])
def test_head_dim_256_matches_pallas_kernel(B, S, window, dtype):
    """recurrentgemma-9b's head dim 256 (16 query heads over 1 kv head),
    causal and windowed: the port's CPU path against the Pallas kernel in
    interpret mode (its wrapper takes D = 256, two lane tiles, unpadded)
    and the materialized oracle."""
    jdt, tdt, tol = DTYPES[dtype]
    (qj, kj, vj), (qt, kt, vt) = _pair(_inputs(B, S, S, 16, 1, 256, S),
                                       jdt, tdt)
    got = ops.flash_gqa(qt, kt, vt, causal=True, window=window)
    assert tuple(got.shape) == (B, S, 16, 256)
    pallas = jax_flash(qj, kj, vj, causal=True, window=window,
                       use_pallas=True, interpret=True)
    oracle = jax_ref(qj, jnp.repeat(kj, 16, 2), jnp.repeat(vj, 16, 2),
                     causal=True, window=window)
    _close(got, pallas, tol)
    _close(got, oracle, tol)


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,Sq", [
    (4, 512, 16, 1, 256, True, 0, None),        # recurrentgemma's prefill
    (1, 300, 16, 1, 256, True, 128, None),
    (4, 1500, 6, 6, 64, False, 0, 64),          # whisper's cross attention
    (4, 1500, 6, 6, 64, False, 0, 1),
])
def test_bf16_mma_plan_meets_card_tolerance_at_new_shapes(B, S, H, Hkv, D,
                                                           causal, window,
                                                           Sq):
    """The bf16 tiled bodies' precision plan (S once a tile of 64 keys, P
    rounded to bf16 before P.V) at head dim 256, the wgmma body's, and at
    whisper's cross attention (Sq queries against S = Skv keys, no mask),
    which the mma body takes at Sq = 64 and would at Sq = 1 without the
    split body (whose plan ``test_split_plan_meets_card_tolerance``
    holds), within the card's bf16 tolerance (2e-2) of attention_ref."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(B, Sq or S, S, H, Hkv, D, S + H))
    kv_head = tuple(h // (H // Hkv) for h in range(H))
    got = _mma_plan_sq(q, k, v, causal=causal, window=window,
                       kv_head=kv_head)
    m = torch.tensor(kv_head)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _mma_plan_sq(q, k, v, *, causal, window, kv_head):
    """``_mma_plan`` with Sq != Skv for a call with no mask: the queries'
    rows pad to Skv's length with zeros, which attend to every key and are
    dropped, as the kernel's rows past Sq are never stored."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq == Skv:
        return _mma_plan(q, k, v, causal=causal, window=window,
                         kv_head=kv_head)
    assert not causal and not window
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Skv - Sq))
    return _mma_plan(qp, k, v, causal=False, window=0,
                     kv_head=kv_head)[:, :Sq]


# ------------------------------------------- the bodies and the split plan
BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_shape,v_shape,dtype,causal,window,want", [
    # whisper's cross attention at a decode step, and at the prefill
    ((4, 1, 6, 64), (4, 1500, 6, 64), BF, False, 0, "wgmma"),
    ((4, 1, 6, 64), (4, 1500, 6, 64), F32, False, 0, "split"),
    ((4, 16, 6, 64), (4, 1500, 6, 64), BF, False, 0, "wgmma"),
    ((4, 16, 6, 64), (4, 1500, 6, 64), F32, False, 0, "split"),
    ((4, 17, 6, 64), (4, 1500, 6, 64), BF, False, 0, "wgmma"),
    ((4, 64, 6, 64), (4, 1500, 6, 64), BF, False, 0, "wgmma"),
    ((4, 64, 6, 64), (4, 1500, 6, 64), F32, False, 0, "fma"),
    # recurrentgemma-9b's prefill, its window, a one-row causal call
    ((4, 512, 16, 256), (4, 512, 1, 256), BF, True, 0, "wgmma"),
    ((1, 4096, 16, 256), (1, 4096, 1, 256), BF, True, 2048, "wgmma"),
    ((4, 512, 16, 256), (4, 512, 1, 256), F32, True, 0, "fma"),
    ((1, 1, 2, 256), (1, 1, 1, 256), BF, True, 0, "wgmma"),
    ((1, 1, 2, 256), (1, 1, 1, 256), BF, False, 0, "wgmma"),
    ((1, 1, 2, 256), (1, 1, 1, 256), F32, False, 0, "split"),
    # a mask keeps the tiled bodies at any Sq; MLA's pair; too many heads
    # or keys for the split body
    ((2, 8, 4, 64), (2, 8, 2, 64), BF, False, 4, "wgmma"),
    ((2, 8, 4, 192), (2, 8, 4, 128), BF, True, 0, "wgmma"),
    ((2, 4, 4, 192), (2, 30, 4, 128), BF, False, 0, "wgmma"),
    ((2, 4, 4, 192), (2, 30, 4, 128), F32, False, 0, "split"),
    ((1, 1, 257, 64), (1, 100, 1, 64), BF, False, 0, "wgmma"),
    ((1, 1, 8, 64), (1, 16385, 1, 64), BF, False, 0, "wgmma"),
    ((1, 1, 8, 64), (1, 16384, 1, 64), F32, False, 0, "split"),
    # whisper's encoder, smollm-135m's train shape, MLA's prefill: wgmma
    # in bf16, fma in f32; the other pairs keep the mma body
    ((4, 1500, 6, 64), (4, 1500, 6, 64), BF, False, 0, "wgmma"),
    ((4, 512, 16, 64), (4, 512, 4, 64), BF, True, 0, "wgmma"),
    ((4, 512, 16, 64), (4, 512, 4, 64), F32, True, 0, "fma"),
    ((4, 512, 16, 192), (4, 512, 16, 128), BF, True, 0, "wgmma"),
    ((4, 512, 16, 192), (4, 512, 16, 128), F32, True, 0, "fma"),
    ((2, 72, 4, 16), (2, 72, 2, 16), BF, True, 0, "mma"),
    ((2, 128, 2, 32), (2, 128, 2, 32), BF, True, 0, "mma"),
    ((4, 512, 32, 128), (4, 512, 2, 128), BF, True, 0, "mma"),
    ((4, 64, 6, 128), (4, 1500, 6, 128), BF, False, 0, "mma"),
    # bf16 with no mask at Sq <= 16 keeps the split body at the pairs
    # the wgmma body does not take
    ((4, 1, 6, 128), (4, 1500, 6, 128), BF, False, 0, "split"),
    ((2, 16, 4, 16), (2, 300, 2, 16), BF, False, 0, "split"),
    ((2, 17, 4, 32), (2, 300, 2, 32), BF, False, 0, "mma"),
])
def test_body_by_shape(q_shape, v_shape, dtype, causal, window, want):
    """The body a call takes (the wrapper passes it to csrc/flash_gqa.cu):
    wgmma for bf16 at (64, 64), (192, 128) and (256, 256) with any mask
    and Sq; else the split body with no mask and at most SPLIT_MAX_SQ
    query rows, heads and keys within its limits; else mma for bf16 at
    the other pairs and fma for f32."""
    assert K.body(q_shape, v_shape, dtype, causal=causal,
                  window=window) == want
    assert want in K.BODY_KERNELS


@pytest.mark.parametrize("B,Skv,Hkv,sms,want", [
    (4, 1500, 6, 132, (12, 125)),      # whisper-tiny's decode: 288 blocks
    (1, 1, 1, 132, (1, 1)),
    (2, 33, 2, 132, (2, 17)),          # at most ceil(Skv / 32) splits
    (4, 4097, 6, 132, (33, 125)),      # at most 128 keys a split
    (1, 16384, 1, 132, (128, 128)),    # at most 128 splits
    (64, 1500, 8, 132, (12, 125)),
    (1, 1500, 1, 8, (16, 94)),
])
def test_split_plan(B, Skv, Hkv, sms, want):
    """The split count and keys a split: about two first-pass blocks an SM
    where Skv allows, at most 128 keys a split (a key a thread of the first
    pass), at most ceil(Skv / 32) and at most 128 splits, no split empty;
    at whisper's decode on an H100's 132 SMs at least 132 blocks."""
    n, keys = K.split_plan(B, Skv, Hkv, sms)
    assert (n, keys) == want
    assert (n - 1) * keys < Skv <= n * keys
    assert keys <= K.SPLIT_MAX_KEYS and n <= K.SPLIT_MAX_SPLITS
    assert n <= -(-Skv // K.SPLIT_MIN_KEYS)
    if (B, Skv, Hkv, sms) == (4, 1500, 6, 132):
        assert n * B * Hkv >= sms


@pytest.mark.parametrize("q_shape,v_shape,n_split,want", [
    ((4, 1, 6, 64), (4, 1500, 6, 64), 12, 4 * 6 * 12 * 66),
    ((2, 16, 8, 192), (2, 30, 4, 128), 1, 2 * 16 * 8 * 130),
])
def test_split_scratch_numel(q_shape, v_shape, n_split, want):
    """The split body's f32 scratch: each query row's partial o [Dv], m
    and l for each split."""
    assert K.split_scratch_numel(q_shape, v_shape, n_split) == want


def test_split_limits_match_the_source():
    """The wrapper's limits of the split body are the source's: a call
    the wrapper splits is one the C entry takes."""
    src = (Path(K.__file__).parent / "csrc" / "flash_gqa.cu").read_text()
    defines = dict(re.findall(r"#define (FS_\w+) (\d+)", src))
    assert int(defines["FS_MAX_SQ"]) == K.SPLIT_MAX_SQ
    assert int(defines["FS_MAX_H"]) == K.SPLIT_MAX_H
    assert int(defines["FS_MAX_CH"]) == K.SPLIT_MAX_KEYS
    assert int(defines["FS_THREADS"]) >= K.SPLIT_MAX_KEYS
    assert int(defines["FS_MAX_SPLITS"]) == K.SPLIT_MAX_SPLITS


@pytest.mark.parametrize("B,Sq,Skv,H,D,Dv,sms,want", [
    (4, 64, 1500, 6, 64, 64, 132, (0, 8, 192)),      # whisper's cross
    (4, 17, 1500, 6, 64, 64, 132, (0, 8, 192)),
    (2, 200, 1500, 6, 64, 64, 132, (0, 8, 192)),     # 2 query tiles a head
    (4, 1500, 1500, 6, 64, 64, 132, (264, 8, 192)),  # the encoder's tail
    (8, 1500, 1500, 6, 64, 64, 132, (528, 5, 320)),
    (2, 1500, 1500, 11, 64, 64, 132, (264, 1, 1536)),  # one full wave
    (2, 1500, 1500, 19, 64, 64, 132, (456, 1, 1536)),  # tail past half
    (1, 1, 16385, 8, 64, 64, 132, (0, 33, 512)),
    (2, 65, 1, 6, 64, 64, 132, (12, 1, 64)),         # one kv tile
    (2, 17, 33, 6, 64, 64, 132, (12, 1, 64)),
    (1, 200, 200, 16, 256, 256, 132, (0, 4, 64)),
    (4, 64, 1500, 6, 64, 64, 8, (16, 2, 768)),       # tail of half a wave
    (2, 65, 4097, 4, 192, 128, 132, (0, 11, 384)),   # kv tiles of 128 keys
    (1, 100, 100, 4, 192, 128, 132, (4, 1, 128)),
])
def test_wgmma_split_plan(B, Sq, Skv, H, D, Dv, sms, want):
    """The wgmma body's kv split in a call with no mask: the items (b, h,
    query tile of 128 rows) past the last full wave of blocks (2 an SM at
    (64, 64), 1 at the others) are split where they fill at most half a
    wave, into splits of whole kv tiles (64 keys, 128 at (192, 128)),
    about as many as fill one wave, none empty."""
    whole, n, keys = K.wgmma_split_plan((B, Sq, H, D), (B, Skv, H, Dv), sms)
    assert (whole, n, keys) == want
    items = B * H * -(-Sq // K.WGMMA_ROWS)
    slots = K.WGMMA_BLOCKS_PER_SM[(D, Dv)] * sms
    assert keys % K.WGMMA_KEYS[(D, Dv)] == 0
    assert (n - 1) * keys < Skv <= n * keys
    assert whole % slots == 0 or whole == items
    assert (items - whole) * n <= slots
    assert (n == 1) == (whole == items)
    assert K.wgmma_scratch_numel((B, Sq, H, D), (B, Skv, H, Dv), sms) \
        == (items - whole) * K.WGMMA_ROWS * n * (Dv + 2)


def test_wgmma_tiles_match_the_source():
    """The wrapper's wgmma rows and keys are the source's (FW_BQ and
    every pair's FwTile::BK), and the pairs it routes to the wgmma body
    are those the source's launch sends there."""
    src = (Path(K.__file__).parent / "csrc" / "flash_gqa.cu").read_text()
    assert int(re.search(r"#define FW_BQ (\d+)", src).group(1)) \
        == K.WGMMA_ROWS
    tiles = dict(((int(d), int(dv)), int(bk)) for d, dv, bk in re.findall(
        r"struct FwTile<(\d+), (\d+)> \{ static constexpr int BK = (\d+)",
        src))
    assert tiles == K.WGMMA_KEYS
    blocks = dict(((int(d), int(dv)), int(mb)) for d, dv, mb in re.findall(
        r"struct FwTile<(\d+), (\d+)> \{ static constexpr int BK = \d+, "
        r"MINB = (\d+)", src))
    assert blocks == K.WGMMA_BLOCKS_PER_SM
    routed = re.search(r"constexpr bool WGMMA = ([^;]+);", src).group(1)
    pairs = {(int(d), int(dv)) for d, dv in re.findall(
        r"\(D == (\d+) && DV == (\d+)\)", routed)}
    assert pairs == set(K.WGMMA_PAIRS)


def _split_plan(q, k, v, *, kv_head, sms=132):
    """The split body's arithmetic (flash_gqa.cu, flash_gqa_split and
    flash_gqa_merge) in PyTorch on the CPU: every split's f32 scores in
    the log2 domain, its max m, p = 2^(s - m), l and the unnormalized o =
    p.v in f32; then each row's splits merged in split order, o = sum(w o)
    / sum(w l) with w = 2^(m - max m), rounded to q's dtype once. A test
    helper, not the port's plain version."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n, keys = K.split_plan(B, Skv, Hkv, sms)
    m_idx = torch.tensor(kv_head)
    qf = q.float().transpose(1, 2) * (math.log2(math.e) / math.sqrt(D))
    kf = k.index_select(2, m_idx).float().transpose(1, 2)
    vf = v.index_select(2, m_idx).float().transpose(1, 2)
    ms, ls, os_ = [], [], []
    for c0 in range(0, Skv, keys):
        s = qf @ kf[:, :, c0:c0 + keys].transpose(-1, -2)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        os_.append(p @ vf[:, :, c0:c0 + keys])
    assert len(ms) == n
    mx = torch.stack(ms).amax(0)
    l = torch.zeros_like(mx)
    o = torch.zeros_like(os_[0])
    for m, ll, oo in zip(ms, ls, os_):
        w = torch.exp2(m - mx)
        l = l + w * ll
        o = o + w * oo
    return (o / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def _wgmma_split_plan(q, k, v, *, kv_head, sms=132):
    """The wgmma body's arithmetic in a call with no mask and its kv split
    (flash_gqa.cu, flash_gqa_fwd_wgmma with n_split > 1, then
    flash_gqa_merge_tiles for the rows of the split items), in PyTorch on
    the CPU: within each split, kv tiles of WGMMA_KEYS keys, q.k of bf16
    values with f32 sums, the online softmax in the log2 domain with l from
    the f32 probabilities and P rounded to bf16 before P.V (f32 sums); each
    split's unnormalized (m, l, o) in f32, merged in split order and
    rounded to bf16 once; the whole items' rows unsplit. A test helper,
    not the port's plain version."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    whole, n, keys = K.wgmma_split_plan(q.shape, v.shape, sms)
    tile = K.WGMMA_KEYS[(D, v.shape[3])]
    split = _wgmma_split_rows(B, Sq, H, whole)          # [B, H, Sq, 1]
    whole_o = _wgmma_plan(q, k, v, kv_head, Skv, tile)
    split_o = _wgmma_plan(q, k, v, kv_head, keys, tile)
    assert split_o[1] == n or not bool(split.any())
    return torch.where(split.transpose(1, 2), split_o[0], whole_o[0])


def _wgmma_split_rows(B, Sq, H, whole):
    """Which query rows [B, H, Sq, 1] belong to items past ``whole`` (item
    x: (b, h) = x % (B H), query tile n_qt - 1 - x // (B H))."""
    n_qt = -(-Sq // K.WGMMA_ROWS)
    rows = torch.zeros((B * H, n_qt * K.WGMMA_ROWS), dtype=torch.bool)
    for x in range(whole, B * H * n_qt):
        q0 = (n_qt - 1 - x // (B * H)) * K.WGMMA_ROWS
        rows[x % (B * H), q0:q0 + K.WGMMA_ROWS] = True
    return rows[:, :Sq].reshape(B, H, Sq, 1)


def _wgmma_plan(q, k, v, kv_head, keys, tile):
    """-> (o in bf16 [B, Sq, H, Dv], splits): the wgmma body's arithmetic
    over splits of ``keys`` keys (Skv: unsplit), see _wgmma_split_plan."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    m_idx = torch.tensor(kv_head)
    qf = q.float().transpose(1, 2)
    kf = k.index_select(2, m_idx).float().transpose(1, 2)
    vf = v.index_select(2, m_idx).float().transpose(1, 2)
    c = math.log2(math.e) / math.sqrt(D)
    parts = []
    for c0 in range(0, Skv, keys):
        m = torch.full((B, H, Sq, 1), float("-inf"))
        l = torch.zeros((B, H, Sq, 1))
        acc = torch.zeros((B, H, Sq, v.shape[-1]))
        for k0 in range(c0, min(c0 + keys, Skv), tile):
            k1 = min(k0 + tile, Skv)
            s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * c
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.where(m == float("-inf"), 0.0,
                                torch.exp2(m - m_new))
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k1]
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(mx)
    o = torch.zeros_like(parts[0][2])
    for m, ll, oo in parts:
        w = torch.exp2(m - mx)
        l = l + w * ll
        o = o + w * oo
    return (o / l.clamp_min(1e-30)).transpose(1, 2).bfloat16(), len(parts)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,kv_head,sms", [
    (4, 64, 1500, 6, 6, 64, None, 132),  # whisper's cross attention
    (4, 1, 1500, 6, 6, 64, None, 132),   # and at a decode step
    (2, 300, 200, 4, 4, 64, None, 5),    # 24 items: 20 whole, 4 split
    (2, 17, 1500, 6, 6, 64, None, 132),
    (2, 200, 65, 6, 6, 64, None, 132),
    (2, 65, 4097, 4, 4, 192, None, 132),
    (1, 100, 300, 4, 2, 192, None, 132),
    (2, 20, 300, 16, 4, 64, (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0,
                             0), 132),
])
def test_wgmma_split_plan_meets_card_tolerance(B, Sq, Skv, H, Hkv, D,
                                               kv_head, sms):
    """The wgmma body's plan with its kv split (bf16, no mask), repeated on
    the CPU, within the card's bf16 tolerance (2e-2) of attention_ref at
    whisper's cross attention, items split past the last full wave beside
    whole ones, ragged splits and tiles, MLA's head dims and smollm-135m's
    padded map. q is drawn at 3 times the unit scale, so that the softmax
    is sharp and the outputs are O(1): at unit scale it spreads over
    hundreds of keys, outputs are about 0.03, and the tolerance would pass
    an output 10 % off (asserted not to here)."""
    Dv = 128 if D == 192 else D
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in
        ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    kv_head = kv_head or tuple(h // (H // Hkv) for h in range(H))
    assert K.body(q.shape, v.shape, torch.bfloat16, causal=False) == "wgmma"
    assert K.wgmma_split_plan(q.shape, v.shape, sms)[1] > 1
    got = _wgmma_split_plan(q, k, v, kv_head=kv_head, sms=sms)
    m = torch.tensor(kv_head)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=False)
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert not torch.allclose(0.9 * want.float(), want.float(), rtol=2e-2,
                              atol=2e-2)


@pytest.mark.parametrize("mangled,want", [
    ("_Z19flash_gqa_fwd_wgmmaILi64ELi64EEv14CUtensorMap_stS0_S0_PKiP13"
     "__nv_bfloat16PfS5_iiiiifiii", "flash_gqa_fwd_wgmma"),
    ("_Z21flash_gqa_merge_tilesILi64EEvPKfS1_P13__nv_bfloat16iiiiil",
     "flash_gqa_merge_tiles"),
    ("_Z13flash_gqa_fwdILi64ELi64EEvPKfS1_S1_PKiPfiiiiiiif",
     "flash_gqa_fwd"),
    ("_ZN12_GLOBAL__N_15splitEv", "split"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIf"
     "EESt5arrayIPcLm1EEEEviT0_T1_", "vectorized_elementwise_kernel"),
    ("fa_plain_c_kernel", "fa_plain_c_kernel"),
])
def test_function_name_of_a_mangled_kernel(mangled, want):
    """The launch witness (kernels/_graph.py) reads kernels' mangled names
    from the driver and strips each to the identifier BODY_KERNELS uses:
    no namespaces, template arguments or parameters; one name is not a
    prefix of another (flash_gqa_fwd of flash_gqa_fwd_wgmma)."""
    from repro_torch.kernels._graph import function_name
    assert function_name(mangled) == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,kv_head", [
    (4, 1, 1500, 6, 6, 64, None),       # whisper-tiny's decode
    (2, 16, 1500, 6, 6, 64, None),
    (2, 3, 4097, 4, 2, 128, None),
    (1, 2, 33, 4, 1, 256, None),
    (1, 1, 1, 2, 1, 256, None),
    (2, 5, 200, 16, 4, 64, (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)),
])
def test_split_plan_meets_card_tolerance(B, Sq, Skv, H, Hkv, D, kv_head,
                                         dtype):
    """The split body's plan, repeated on the CPU, within the card's
    tolerance (2e-5 in f32, 2e-2 in bf16) of attention_ref, at whisper's
    decode, ragged splits, a single key and smollm-135m's padded map. The
    split body takes these calls in f32 and in bf16 at (128, 128); bf16
    at the wgmma body's pairs takes that body (its kv split), and the
    split body only by name (``_launch(which="split")``)."""
    _, tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _inputs(B, Sq, Skv, H, Hkv, D, Sq + Skv))
    kv_head = kv_head or tuple(h // (H // Hkv) for h in range(H))
    assert K.body(q.shape, v.shape, tdt, causal=False) == (
        "wgmma" if tdt == torch.bfloat16 and (D, D) in K.WGMMA_PAIRS
        else "split")
    got = _split_plan(q, k, v, kv_head=kv_head)
    m = torch.tensor(kv_head)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=False)
    assert got.dtype == tdt and bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
