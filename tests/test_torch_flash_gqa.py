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
    refuses Sq != Skv; so these cases hold the port's oracle against the
    reference's oracle only."""
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
        ops.flash_gqa(*(torch.zeros(1, 8, 2, 256) for _ in range(3)))
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
    (16, 16, True), (64, 64, True), (128, 128, True), (24, 24, False),
    (256, 256, False), (24, 16, False), (64, 32, False)])
def test_kernel_takes_by_shape(D, Dv, takes):
    """``takes``, which the model's attention asks before it sends a CUDA
    call to the kernel, says yes exactly where ``check_args`` does: head
    dims 16-128, v's head dim equal to k's. Head dim 24 and v/k dims that
    differ go to the plain path and are counted there."""
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
    vf = v.index_select(2, m_idx).float().transpose(1, 2)
    c = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
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
