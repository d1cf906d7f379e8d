"""partition_pack of the PyTorch port against the JAX package's Pallas
kernel (interpret mode), exactly, plus the roundtrip and stable-order
properties of the plain version and the CPU/CUDA dispatch rules.

Inputs are made with numpy from a seed and handed to both packages. The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py (on the card)."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.partition_pack.ops import (  # noqa: E402
    partition_pack as jax_partition_pack)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.partition_pack import (  # noqa: E402
    partition_pack as K)
from repro_torch.kernels.partition_pack.ops import (  # noqa: E402
    partition_pack, partition_pack_groups, partition_unpack)

# the JAX package's kernel test shapes: (T, n_parts, capacity, d)
SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
          (1024, 64, 24, 256)]
DTYPES = ["float32", "bfloat16"]


def _inputs(T, P, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, d)).astype(np.float32),
            rng.integers(0, P, T).astype(np.int32))


@pytest.mark.parametrize("T,P,C,d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_pallas_kernel(T, P, C, d, dtype):
    rows, ids = _inputs(T, P, d, T + P)
    buf_j, cnt_j, slot_j = jax_partition_pack(
        jnp.asarray(rows).astype(getattr(jnp, dtype)), jnp.asarray(ids),
        n_parts=P, capacity=C, use_pallas=True, interpret=True)
    buf_t, cnt_t, slot_t = partition_pack(
        torch.from_numpy(rows).to(getattr(torch, dtype)),
        torch.from_numpy(ids), n_parts=P, capacity=C)
    assert buf_t.dtype == getattr(torch, dtype)
    assert cnt_t.dtype == slot_t.dtype == torch.int32
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(buf_t.float().numpy(),
                                  np.asarray(buf_j, np.float32))


def test_groups_share_one_slot_pass():
    """Packing [int64 view, int32 view] together equals packing each."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 6, 500).astype(np.int32))
    g8 = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, (500, 3)))
    g4 = torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, (500, 2))
                          .astype(np.int32))
    (b8, b4), counts, slots = partition_pack_groups(
        [g8, g4], ids, n_parts=6, capacity=120)
    for g, b in ((g8, b8), (g4, b4)):
        buf, c, s = partition_pack(g, ids, n_parts=6, capacity=120)
        assert torch.equal(b, buf) and torch.equal(counts, c) \
            and torch.equal(slots, s)


@settings(max_examples=30, deadline=None)
@given(st.integers(2, 8), st.integers(1, 6), st.integers(10, 80),
       st.integers(0, 2 ** 31 - 1))
def test_property_roundtrip(P, Cdiv, T, seed):
    """unpack(pack(x)) == x for all kept rows; dropped rows are zero."""
    C = max(T // (P * Cdiv), 1)
    rows, ids = _inputs(T, P, 8, seed)
    ids_t = torch.from_numpy(ids)
    buf, counts, slots = partition_pack(torch.from_numpy(rows), ids_t,
                                        n_parts=P, capacity=C)
    back = partition_unpack(buf, ids_t, slots, C).numpy()
    keep = slots.numpy() < C
    np.testing.assert_array_equal(back[keep], rows[keep])
    assert np.all(back[~keep] == 0)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=P))


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 6), st.integers(16, 64), st.integers(0, 2 ** 31 - 1))
def test_property_partition_major_order(P, T, seed):
    """Within each partition, rows keep arrival order (stable pack)."""
    _, ids = _inputs(T, P, 1, seed)
    rows = torch.arange(T, dtype=torch.float32)[:, None] * torch.ones(1, 4)
    buf, counts, _ = partition_pack(rows, torch.from_numpy(ids),
                                    n_parts=P, capacity=T)
    for p in range(P):
        vals = buf[p, :int(counts[p]), 0].numpy()
        assert np.all(np.diff(vals) > 0), (p, vals)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version itself."""
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.pack([torch.zeros(4, 2)], ids, 2, 4)


def test_build_names_every_source_by_content():
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["flash_gqa.cu", "moe_combine.cu",
                                     "partition_pack.cu", "ssd_scan.cu"]
    for src in srcs:
        lib = _build.target(src)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
        assert lib.stem.startswith(src.stem + "-")


def test_pack_by_key_refuses_cpu_tensors():
    """The shuffle producer's kernel entry never runs the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        K.pack_by_key([torch.zeros(4, 2)], torch.arange(4), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_pack_by_key_refuses_a_float_key(dtype):
    with pytest.raises(ValueError, match="integer"):
        K.pack_by_key([], torch.zeros(4, dtype=dtype), 2)


@pytest.mark.parametrize("n_parts", [0, -3, K.MAX_PARTS + 1])
def test_pack_by_key_refuses_n_parts_out_of_range(n_parts):
    with pytest.raises(ValueError, match="outside"):
        K.pack_by_key([], torch.arange(4), n_parts)


def test_pack_by_key_refuses_non_contiguous_groups():
    g = torch.zeros(2, 4, dtype=torch.int32).t()
    assert g.shape == (4, 2) and not g.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        K.pack_by_key([g], torch.arange(4), 2)
    with pytest.raises(ValueError, match="at most"):
        K.pack_by_key([torch.zeros(4, 1)] * (K.MAX_GROUPS + 1),
                      torch.arange(4), 2)


def test_workspace_tickets_epochs_and_status():
    """A call's tickets start where the last call's ended, every call has a
    new epoch, the status words grow (zeroed) and are zeroed again only
    when the epoch wraps."""
    ws = K.Workspace("cpu")
    assert ws.place(3, 8) == (0, 1)
    assert ws.status.numel() == 24 and not ws.status.any()
    ws.status.fill_(7)
    assert ws.place(2, 8) == (3, 2)
    assert ws.status.numel() == 24 and bool((ws.status == 7).all())
    assert ws.place(5, 8) == (5, 3)
    assert ws.status.numel() == 48 and not ws.status.any()
    assert ws.hash(4) == 0 and ws.hash(2) == 4 and ws.issued == [10, 6]
    ws.status.fill_(7)
    ws.epoch = K.EPOCH_LIMIT - 1
    assert ws.place(1, 8) == (10, 1)
    assert not ws.status.any()
    assert ws.ticket(1) == ws.ticket(0) + 8
    assert not ws.acc.any() and ws.acc.numel() == K.MAX_PARTS


def test_op_partition_of_an_empty_table_on_the_cpu():
    from repro_torch.relational.ops import op_partition
    from repro_torch.relational.table import Table
    t = Table({"k": torch.zeros(0, dtype=torch.int64),
               "v": torch.zeros(0, dtype=torch.int32)})
    parts = op_partition(t, "k", 3)
    assert len(parts) == 3
    for p in parts:
        assert len(p) == 0 and p.column_names() == ["k", "v"]
        assert p["k"].dtype == torch.int64 and p["v"].dtype == torch.int32
