"""ssd_scan of the PyTorch port against the JAX package's Pallas kernel
(interpret mode): the CPU path of the port's ``ops.ssd`` (the plain chunked
SSD) at the Pallas kernel test's shapes, the recurrence it must equal, and
the CPU/CUDA dispatch rules, and the CUDA kernels' precision plan (the
3xTF32 split and the chunk-parallel order) repeated on the CPU against the
plain version at the card's tolerances.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py (on the card)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as K  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_sequential)

# the JAX package's kernel test shapes (tests/test_kernel_ssd.py)
CASES = [
    # B, S, H, P, G, N, chunk
    (1, 128, 2, 32, 1, 32, 64),
    (2, 256, 4, 64, 2, 64, 128),
    (1, 256, 2, 64, 1, 128, 128),
    (2, 64, 2, 16, 1, 16, 32),
]


def _inputs(B, S, H, P, G, N, seed):
    """x, dt (post-softplus), A (negative), Bm, Cm as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0).astype(f),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
            (rng.standard_normal((B, S, G, N)) * 0.3).astype(f),
            (rng.standard_normal((B, S, G, N)) * 0.3).astype(f))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES)
def test_plain_matches_pallas_kernel(B, S, H, P, G, N, chunk):
    arrs = _inputs(B, S, H, P, G, N, seed=S + P)
    y_j, st_j = jax_ssd(*map(jnp.asarray, arrs), chunk=chunk,
                        use_pallas=True, interpret=True)
    before = K.launches
    y_t, st_t = ssd(*map(torch.from_numpy, arrs), chunk=chunk)
    assert K.launches == before                  # CPU: the plain version
    assert y_t.dtype == torch.float32 and st_t.dtype == torch.float32
    assert tuple(st_t.shape) == (B, H, P, N)
    _close(y_t, y_j, 2e-4)
    _close(st_t, st_j, 2e-4)


def test_bf16_plain_matches_pallas_kernel():
    """bf16 x, B, C (the serve path's compute dtype): the state is f32 math
    on the same bf16 values (2e-4); y is rounded to bf16 once on each side
    from f32 sums in another order, so one bf16 step apart at most."""
    arrs = _inputs(2, 256, 4, 64, 2, 64, seed=3)
    x, dt, A, Bm, Cm = arrs
    y_j, st_j = jax_ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                        jnp.asarray(A), jnp.asarray(Bm, jnp.bfloat16),
                        jnp.asarray(Cm, jnp.bfloat16), chunk=128,
                        use_pallas=True, interpret=True)
    bf = torch.bfloat16
    y_t, st_t = ssd(torch.from_numpy(x).to(bf), torch.from_numpy(dt),
                    torch.from_numpy(A), torch.from_numpy(Bm).to(bf),
                    torch.from_numpy(Cm).to(bf), chunk=128)
    assert y_t.dtype == bf
    _close(st_t, st_j, 2e-4)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32),
                               rtol=2 ** -7, atol=2e-4)


def test_chunked_matches_sequential():
    arrs = [torch.from_numpy(a) for a in _inputs(2, 64, 2, 16, 1, 16, 9)]
    y_c, st_c = ssd_chunked(*arrs, 16)
    y_s, st_s = ssd_sequential(*arrs)
    _close(y_c, y_s.numpy(), 1e-4)
    _close(st_c, st_s.numpy(), 1e-4)


def test_short_sequence_takes_one_chunk():
    """S < chunk: the chunk becomes S (ops.py:34 of the reference)."""
    arrs = _inputs(1, 24, 2, 16, 1, 16, seed=4)
    y_j, st_j = jax_ssd(*map(jnp.asarray, arrs), chunk=128,
                        use_pallas=True, interpret=True)
    y_t, st_t = ssd(*map(torch.from_numpy, arrs), chunk=128)
    _close(y_t, y_j, 2e-4)
    _close(st_t, st_j, 2e-4)


def test_sequence_must_divide_into_chunks():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 48, 2, 16, 1, 16, 5)]
    with pytest.raises(ValueError, match="chunks of 32"):
        ssd(*arrs, chunk=32)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: a CPU tensor is an error, raised
    before any build."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 32, 2, 16, 1, 16, 6)]
    before = K.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.ssd_scan(*arrs, chunk=32)
    assert K.launches == before


@pytest.mark.parametrize("key,prefix,want", [
    ("void ssd_chunk_scan<__nv_bfloat16>(__nv_bfloat16 const*, float "
     "const*)", "ssd_chunk_scan", True),
    ("void pp_gather<unsigned int>(unsigned int const*, int const*)",
     "pp_", True),
    ("pp_tile_hist(int const*, long, int, int, int*)", "pp_", True),
    ("void at::native::elementwise_kernel<128, 4>(int)", "pp_", False),
    ("aten::mm", "ssd_chunk_scan", False),
    ("void ssd_chunk_state<float>(float const*, float const*)", "ssd_",
     True),
    ("ssd_state_pass(float*, float const*, float*, int, int, int)", "ssd_",
     True),
    ("void flash_gqa_fwd_mma<128>(__nv_bfloat16 const*)", "flash_gqa_fwd",
     True)])
def test_profiles_find_template_kernels(key, prefix, want):
    """The profilers sum a kernel's device time by its function name,
    template kernels ("void name<T>(...)") included."""
    from repro_torch.launch.profile_query import is_kernel
    assert is_kernel(key, prefix) is want


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads an f32 register in a TF32 product: the
    low 13 mantissa bits dropped (truncation to TF32's 10 bits)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _mm3(a, b, a_exact: bool, b_exact: bool):
    """a @ b as the kernels' 3xTF32 split computes it: hi = tf32(x),
    lo = x - hi (read as tf32(lo) by the tensor core), a_lo.b_hi +
    a_hi.b_lo + a_hi.b_hi with f32 sums; the term of an operand exact in
    TF32 (a bf16 input) is skipped."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if not a_exact:
        out = out + _tf32(a - ah) @ bh
    if not b_exact:
        out = out + ah @ _tf32(b - bh)
    return out


def _plan_ssd(x, dt, A, Bm, Cm, chunk, mm=_mm3):
    """The roundings and the order of the chunk-parallel kernels
    (ssd_scan.cu), in PyTorch on the CPU: C.B^T once per (b, chunk,
    group); each chunk's own state; the sequential pass of the states
    across chunks; y = exp(cs) o (C.state_in) + ((C.B^T) o L).(x*dt).
    Every product is ``mm`` (the 3xTF32 split); x*dt, the decays and L
    are f32 as in the kernels. A test helper, not the port's plain version."""
    exact = x.dtype == torch.bfloat16
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, Q = H // G, min(chunk, S)
    nc = S // Q
    xdt = (x.float() * dt[..., None]).reshape(Bsz, nc, Q, H, P)
    cs = torch.cumsum((dt * A).reshape(Bsz, nc, Q, H), dim=2)
    cs = cs.permute(0, 1, 3, 2)                             # [B,nc,H,Q]
    Bc = Bm.float().reshape(Bsz, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    Cc = Cm.float().reshape(Bsz, nc, Q, G, N).permute(0, 1, 3, 2, 4)
    cb = mm(Cc, Bc.transpose(-1, -2), exact, exact)      # [B,nc,G,Q,Q]
    xdt = xdt.permute(0, 1, 3, 2, 4)                        # [B,nc,H,Q,P]
    xdec = xdt * torch.exp(cs[..., -1:] - cs)[..., None]
    Bh = Bc.repeat_interleave(rep, dim=2)                   # [B,nc,H,Q,N]
    Ch = Cc.repeat_interleave(rep, dim=2)
    own = mm(xdec.transpose(-1, -2), Bh, False, exact)    # [B,nc,H,P,N]
    state = torch.zeros((Bsz, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = torch.exp(cs[:, c, :, -1])[..., None, None] * state \
            + own[:, c]
    y_off = mm(Ch, torch.stack(entering, 1).transpose(-1, -2), exact,
                 False) * torch.exp(cs)[..., None]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    M = torch.where(tri, cb.repeat_interleave(rep, dim=2) * L, 0.0)
    y = y_off + mm(M, xdt, False, False)                  # [B,nc,H,Q,P]
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P).to(x.dtype), state


PLAN_CASES = [*CASES,
              (2, 16, 8, 16, 1, 16, 8),                  # the smoke chunk
              (1, 24, 2, 16, 1, 16, 128),                # S < chunk
              (2, 256, 4, 64, 2, 64, 64),                # two groups, Q 64
              (4, 512, 80, 64, 1, 128, 128)]             # mamba2-2.7b


def test_bf16_is_exact_in_tf32():
    """The split skips the low part of a bf16 operand: bf16's 8-bit
    mantissa fits TF32's 10 bits, so tf32(x) == x."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)).bfloat16().float()
    assert torch.equal(_tf32(x), x)
    f = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11)])
    assert _tf32(f).tolist() == [1.0, 1 + 2 ** -10, -1.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", PLAN_CASES)
def test_3xtf32_plan_meets_card_tolerance(B, S, H, P, G, N, chunk, dtype):
    """The kernels' precision plan and chunk-parallel order, repeated on the
    CPU, stay within the card's tolerances of ssd_chunked at every case and
    the serve path's shape: y and state 2e-4 in f32; in bf16 the state
    2e-4 and y one bf16 step (2^-7 relative)."""
    arrs = [torch.from_numpy(a) for a in _inputs(B, S, H, P, G, N, S + P)]
    if dtype == "bfloat16":
        arrs = [a.bfloat16() if i in (0, 3, 4) else a
                for i, a in enumerate(arrs)]
    y, st = _plan_ssd(*arrs, chunk)
    y_r, st_r = ssd_chunked(*arrs, chunk)
    assert y.dtype == arrs[0].dtype
    torch.testing.assert_close(st, st_r, rtol=2e-4, atol=2e-4)
    rtol = 2e-4 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(y.float(), y_r.float(), rtol=rtol, atol=2e-4)


def test_tf32_alone_misses_the_f32_tolerance():
    """Why the split: one TF32 pass per product (about three digits) puts
    f32 y and the state past 2e-4 of the plain version at the serve path's
    shape."""
    arrs = [torch.from_numpy(a)
            for a in _inputs(4, 512, 80, 64, 1, 128, 512 + 64)]
    y, st = _plan_ssd(*arrs, 128, mm=lambda a, b, *_: _tf32(a) @ _tf32(b))
    y_r, st_r = ssd_chunked(*arrs, 128)
    err = max(float(((y - y_r).abs() - 2e-4 * y_r.abs()).max()),
              float(((st - st_r).abs() - 2e-4 * st_r.abs()).max()))
    assert err > 2e-4
