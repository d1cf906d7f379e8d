"""ssd_scan of the PyTorch port against the JAX package's Pallas kernel
(interpret mode): the CPU path of the port's ``ops.ssd`` (the plain chunked
SSD) at the Pallas kernel test's shapes, the recurrence it must equal, and
the CPU/CUDA dispatch rules.

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
    ("aten::mm", "ssd_chunk_scan", False)])
def test_profiles_find_template_kernels(key, prefix, want):
    """The profilers sum a kernel's device time by its function name,
    template kernels ("void name<T>(...)") included."""
    from repro_torch.launch.profile_query import is_kernel
    assert is_kernel(key, prefix) is want
