"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without a
card; this file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.partition_pack import (  # noqa: E402
    partition_pack as K, ref)

SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
          (1024, 64, 24, 256), (100_000, 1024, 160, 3)]
DTYPES = ["float32", "bfloat16", "int64", "int32"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,P,C,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_partition_pack_kernel_matches_plain(card, T, P, C, d, dtype):
    rng = np.random.default_rng(T + P)
    rows = torch.from_numpy(rng.standard_normal((T, d)) * 1000).to(
        getattr(torch, dtype)).to(card)
    ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)).to(card)
    before = K.launches
    (buf,), counts, slots = K.pack([rows], ids, P, C)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want, want_counts, want_slots, _ = ref.pack(rows, ids, P, C)
    assert torch.equal(counts, want_counts)
    assert torch.equal(slots, want_slots)
    assert torch.equal(buf, want)
