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
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.flash_gqa.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SK  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402

SHAPES = [(32, 8, 4, 16), (256, 16, 24, 64), (300, 7, 64, 128),
          (1024, 64, 24, 256), (100_000, 1024, 160, 3)]
DTYPES = ["float32", "bfloat16", "int64", "int32"]


# ssd_scan: the Pallas kernel test's CASES, the smoke config's chunk,
# a sequence shorter than its chunk, and the serve path's main shape
SSD_CASES = [
    # B, S, H, P, G, N, chunk
    (1, 128, 2, 32, 1, 32, 64),
    (2, 256, 4, 64, 2, 64, 128),
    (1, 256, 2, 64, 1, 128, 128),
    (2, 64, 2, 16, 1, 16, 32),
    (2, 16, 8, 16, 1, 16, 8),
    (1, 24, 2, 16, 1, 16, 128),
    (4, 512, 80, 64, 1, 128, 128),
]


# flash_gqa: the Pallas kernel test's CASES, a head dim of 16, a
# bidirectional window, smollm-135m's padded-head map (16 q heads over 4
# kv heads, padded q heads on kv head 0) and the serve path's main shape
# (glm4-9b: 32 q heads over 2 kv heads, D 128)
SMOLLM_MAP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)
FLASH_CASES = [
    # B, S, H, Hkv, D, causal, window, kv_head
    (1, 128, 2, 2, 64, True, 0, None),
    (2, 256, 4, 2, 64, True, 0, None),
    (1, 256, 3, 1, 128, True, 0, None),
    (2, 128, 2, 2, 32, True, 0, None),
    (1, 384, 2, 1, 64, True, 128, None),
    (1, 200, 2, 2, 64, True, 0, None),
    (2, 72, 4, 2, 16, True, 0, None),
    (1, 200, 4, 2, 64, False, 48, None),
    (2, 130, 16, 4, 64, True, 0, SMOLLM_MAP),
    (4, 512, 32, 2, 128, True, 0, None),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    # the plain versions' products in full f32, as the kernel computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


# the redesigned pack at its edges (tile = K.TILE_ROWS = 2048 rows; the
# look-back route up to K.LOOKBACK_MAX_PARTS = 64 partitions, multi-pass
# above)
TILE = 2048
PACK_PARTS = [1, 8, 64, 1024, 8192]
PACK_ROWS = [1, TILE - 1, TILE + 1, 3 * TILE + 5]


def _pack_vs_plain(groups, ids, P, C):
    """The kernel against the plain version, exactly: rows whose id lies in
    [0, P) are ranked among themselves (ref.pack_indices over them), the
    others get slot -1 and land nowhere. -> the kernel's counts."""
    before = K.launches
    bufs, counts, slots = K.pack(groups, ids, P, C)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    valid = (ids >= 0) & (ids < P)
    slot_v, want_counts, keep = ref.pack_indices(ids[valid], P, C)
    want_slots = torch.full_like(ids, -1)
    want_slots[valid] = slot_v
    assert torch.equal(counts, want_counts)
    assert torch.equal(slots, want_slots)
    for g, buf in zip(groups, bufs):
        want = ref.pack_rows(g[valid], ids[valid], slot_v, keep, P, C)
        assert buf.dtype == g.dtype and buf.shape == want.shape
        assert torch.equal(buf, want)
    return counts


def _mixed_groups(T, seed, dev):
    """2-, 4- and 8-byte groups in one call, one of them 4 bytes off the
    allocation's start (so its rows go in narrower vectors)."""
    rng = np.random.default_rng(seed)
    g2 = torch.from_numpy(rng.standard_normal((T, 3)).astype(np.float32)) \
        .to(torch.bfloat16).to(dev)
    g4 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (T, 5))
                          .astype(np.int32)).to(dev)
    g8 = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, (T, 2),
                                       dtype=np.int64)).to(dev)
    flat = torch.from_numpy(rng.integers(0, 2 ** 31, T * 4 + 1)
                            .astype(np.int32)).to(dev)
    shifted = flat[1:].view(T, 4)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    return [g2, g4, g8, shifted]


@pytest.mark.cuda
@pytest.mark.parametrize("P", PACK_PARTS)
def test_partition_pack_parts(card, P):
    """Both routes at every partition count, capacity the largest count."""
    T = 40_000
    rng = np.random.default_rng(P)
    ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)).to(card)
    cap = int(torch.bincount(ids, minlength=P).max())
    _pack_vs_plain(_mixed_groups(T, P, card), ids, P, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 64, 2048])
def test_partition_pack_hot_key(card, P):
    """Every row in one partition: one run through all tiles."""
    T = 5 * TILE + 17
    ids = torch.full((T,), P - 1, dtype=torch.int32, device=card)
    counts = _pack_vs_plain(_mixed_groups(T, 3, card), ids, P, T)
    assert int(counts[P - 1]) == T and int(counts.sum()) == T


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 64, 2048])
@pytest.mark.parametrize("T", PACK_ROWS)
def test_partition_pack_tile_edges(card, T, P):
    rng = np.random.default_rng(T)
    ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)).to(card)
    cap = int(torch.bincount(ids, minlength=P).max())
    _pack_vs_plain(_mixed_groups(T, T, card), ids, P, cap + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 64, 2048])
@pytest.mark.parametrize("cap_of", ["zero", "below"])
def test_partition_pack_drops(card, P, cap_of):
    """Capacity 0 (empty buffers, counts and slots still right) and a
    capacity below the largest count (rows past it dropped)."""
    T = 3 * TILE + 100
    rng = np.random.default_rng(P + 1)
    ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)).to(card)
    top = int(torch.bincount(ids, minlength=P).max())
    cap = 0 if cap_of == "zero" else max(top // 2, 1)
    _pack_vs_plain(_mixed_groups(T, P, card), ids, P, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 64, 1024])
def test_partition_pack_ids_out_of_range(card, P):
    """Ids below 0 or at n_parts and above: slot -1, not counted, not
    packed; the other rows ranked among themselves."""
    T = 2 * TILE + 33
    rng = np.random.default_rng(P + 2)
    ids = rng.integers(0, P, T).astype(np.int32)
    bad = rng.random(T) < 0.1
    ids[bad] = rng.choice([-1, -7, P, P + 5, 2 ** 31 - 1], bad.sum())
    ids = torch.from_numpy(ids).to(card)
    _pack_vs_plain(_mixed_groups(T, P, card), ids, P, T)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 16, 64, 1024])
def test_partition_pack_kernels_per_call(card, P):
    """Two CUDA kernels a pack call up to the look-back threshold
    (K.LOOKBACK_MAX_PARTS), three above (the multi-pass route), all of
    them partition_pack's: no fill or copy (the workspace is warm after
    the first call)."""
    from torch.profiler import ProfilerActivity, profile
    T = 100_000
    rng = np.random.default_rng(P)
    ids = torch.from_numpy(rng.integers(0, P, T).astype(np.int32)).to(card)
    groups = _mixed_groups(T, P, card)[:3]
    K.pack(groups, ids, P, T // P * 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.pack(groups, ids, P, T // P * 2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == (2 if P <= K.LOOKBACK_MAX_PARTS else 3), names
    assert all(n.split("<")[0].split("(")[0].split()[-1].startswith("pp_")
               for n in names), names


_KEYS = [0, -1, 1, -2 ** 63, 2 ** 63 - 1, 12345, -98765]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 1024])
def test_pack_by_key_ids_equal_partition_ids(card, n):
    """splitmix64 mod n in native uint64 on the card equals the int64
    emulation of relational.ops.partition_ids, bit for bit; the pack is
    the plain pack at capacity = the largest count."""
    from repro_torch.relational.ops import partition_ids
    rng = np.random.default_rng(n)
    keys = np.concatenate([np.asarray(_KEYS, np.int64),
                           rng.integers(-2 ** 63, 2 ** 63 - 1, 50_000,
                                        dtype=np.int64)])
    key = torch.from_numpy(keys).to(card)
    groups = _mixed_groups(len(keys), n, card)
    before = K.launches
    bufs, counts, ids = K.pack_by_key(groups, key, n)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want_ids = partition_ids(key, n)
    assert torch.equal(ids, want_ids)
    assert counts == torch.bincount(want_ids, minlength=n).tolist()
    cap = max(counts)
    for g, buf in zip(groups, bufs):
        want, _, _, _ = ref.pack(g, want_ids, n, cap)
        assert torch.equal(buf, want)
    # another integer type is hashed as its int64 value
    small = key[:1000].to(torch.int32)
    _, c32, ids32 = K.pack_by_key([], small, n)
    assert torch.equal(ids32, partition_ids(small.to(torch.int64), n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64])
def test_op_partition_syncs_once(card, n):
    """op_partition on a CUDA table: one host sync (the counts), no
    elementwise hash kernel, and the CPU op_partition's partitions."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.relational import ops
    from repro_torch.relational.table import DictColumn
    from repro_torch.relational.tpch import generate
    li = generate(0.01, seed=3)["lineitem"]
    t = li.project(["l_orderkey", "l_quantity", "l_shipdate",
                    "l_shipmode", "l_extendedprice"])
    want = ops.op_partition(t, "l_orderkey", n)
    on_card = t.to(card)
    ops.op_partition(on_card, "l_orderkey", n)          # warm workspace
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = ops.op_partition(on_card, "l_orderkey", n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.op_partition(on_card, "l_orderkey", n)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not any("elementwise" in nm or "bincount" in nm for nm in names), \
        names
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.column_names() == w.column_names()
        for c in w.column_names():
            a, b = g[c], w[c]
            if isinstance(b, DictColumn):
                assert a.values == b.values
                a, b = a.codes, b.codes
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _ssd_inputs(B, S, H, P, G, N, seed, dev):
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = (rng.standard_normal((B, S, H, P)).astype(f),
            np.logaddexp(rng.standard_normal((B, S, H)) - 1.0, 0).astype(f),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
            (rng.standard_normal((B, S, G, N)) * 0.3).astype(f),
            (rng.standard_normal((B, S, G, N)) * 0.3).astype(f))
    return [torch.from_numpy(a).to(dev) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(card, B, S, H, P, G, N, chunk):
    """3xTF32 products in the kernels, f32 sums in another order in the
    plain version: 2e-4, the Pallas kernel test's tolerance."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, G, N, S + P, card)
    before = SK.launches
    y, st = SK.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert SK.launches == before + 1
    y_r, st_r = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(y, y_r, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_r, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_ssd_scan_kernel_bf16_at_main_shape(card):
    """bf16 x, B, C, y as on the serve path: the state is f32 math on the
    same values (2e-4); y is rounded to bf16 once on each side from f32
    sums in another order, so one bf16 step (2^-7 relative) apart."""
    x, dt, A, Bm, Cm = _ssd_inputs(4, 512, 80, 64, 1, 128, 11, card)
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, st = SK.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    y_r, st_r = ssd_chunked(x, dt, A, Bm, Cm, 128)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(st, st_r, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y.float(), y_r.float(), rtol=2 ** -7,
                               atol=2e-4)


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_what_it_does_not_take(card):
    x, dt, A, Bm, Cm = _ssd_inputs(1, 512, 2, 16, 1, 16, 1, card)
    with pytest.raises(ValueError, match="chunks of at most"):
        SK.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        SK.ssd_scan(x.transpose(1, 2), dt, A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SK.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), chunk=64)


def _flash_inputs(B, S, H, Hkv, D, seed, dev, dtype):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, S, H, D)),
            rng.standard_normal((B, S, Hkv, D)),
            rng.standard_normal((B, S, Hkv, D)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,kv_head", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_kernel_matches_plain(card, B, S, H, Hkv, D, causal,
                                        window, kv_head, dtype):
    """f32 FMA in the kernel's f32 body, f32 scores and softmax in the
    plain version (attention_ref over k/v gathered by the map): 2e-5, the
    Pallas kernel test's tolerance. bf16 runs on the tensor cores with P
    rounded to bf16, held at that test's 2e-2."""
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(B, S, H, Hkv, D, S + H, card, dt)
    before = FK.launches
    o = FK.flash_gqa(q, k, v, causal=causal, window=window, kv_head=kv_head)
    torch.cuda.synchronize()
    assert FK.launches == before + 1
    m = torch.tensor(kv_head if kv_head is not None
                     else [h // (H // Hkv) for h in range(H)], device=card)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
    assert o.dtype == dt and o.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_gqa_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _flash_inputs(1, 64, 4, 2, 64, 1, card, torch.float32)
    before = FK.launches
    with pytest.raises(ValueError, match="Sq == Skv"):
        FK.flash_gqa(q[:, :32].contiguous(), k, v)
    big = _flash_inputs(1, 64, 2, 2, 256, 1, card, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        FK.flash_gqa(*big)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_gqa(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_gqa(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="kv_head"):
        FK.flash_gqa(q, k, v, kv_head=(0, 1, 2, 0))
    shifted = torch.zeros(q.numel() + 1, device=card)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_gqa(shifted, k, v)
    assert FK.launches == before


# the bf16 tensor-core body at the edges of its 64-row tiles: ragged S
# (one row, one short of and one past a tile, two tiles and a bit), the
# smallest head dim, a window narrower than one tile, the padded map
FLASH_EDGES = [
    # B, S, H, Hkv, D, causal, window, kv_head
    (2, 1, 4, 2, 64, True, 0, None),
    (1, 63, 4, 2, 128, True, 0, None),
    (1, 65, 4, 2, 128, True, 0, None),
    (2, 130, 4, 1, 32, True, 0, None),
    (1, 200, 2, 2, 128, False, 0, None),
    (2, 200, 4, 2, 16, True, 0, None),
    (1, 200, 4, 2, 64, True, 24, None),
    (1, 130, 4, 2, 64, False, 24, None),
    (1, 130, 16, 4, 64, True, 0, SMOLLM_MAP),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,kv_head", FLASH_EDGES)
def test_flash_gqa_bf16_tile_edges(card, B, S, H, Hkv, D, causal, window,
                                   kv_head):
    """bf16 q.k and P.V on the tensor cores, P rounded to bf16: within the
    bf16 tolerance of attention_ref at the tiles' edges (rows and keys past
    S are zero-filled and masked, never read)."""
    q, k, v = _flash_inputs(B, S, H, Hkv, D, S + D, card, torch.bfloat16)
    o = FK.flash_gqa(q, k, v, causal=causal, window=window, kv_head=kv_head)
    torch.cuda.synchronize()
    m = torch.tensor(kv_head if kv_head is not None
                     else [h // (H // Hkv) for h in range(H)], device=card)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
    assert bool(torch.isfinite(o.float()).all())
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


# the chunk-parallel ssd_scan at its edges: two groups reading their own
# C.B^T, a chunk of 64 (one cb tile), small and mid state sizes, a
# sequence shorter than its chunk, P wider than one 64-column slice, and
# P, N and chunk that are no multiples of 8 (the loads' scalar paths)
SSD_EDGES = [
    # B, S, H, P, G, N, chunk
    (2, 256, 4, 64, 2, 64, 64),
    (1, 192, 6, 32, 2, 16, 64),
    (2, 128, 4, 64, 1, 64, 128),
    (1, 40, 2, 16, 1, 16, 128),
    (1, 96, 2, 80, 1, 32, 32),
    (1, 36, 3, 20, 1, 20, 12),
    (2, 90, 4, 12, 2, 36, 90),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_EDGES)
def test_ssd_scan_tile_edges(card, B, S, H, P, G, N, chunk, dtype):
    """3xTF32 products: y and state within 2e-4 of the plain version in
    f32; in bf16 the state so too and y within one bf16 step."""
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, G, N, S + N, card)
    if dtype == "bfloat16":
        x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, st = SK.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    y_r, st_r = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(st, st_r, rtol=2e-4, atol=2e-4)
    rtol = 2e-4 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(y.float(), y_r.float(), rtol=rtol, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,functions", [
    ("flash_gqa", ["flash_gqa_fwd_mma<16>", "flash_gqa_fwd_mma<32>",
                   "flash_gqa_fwd_mma<64>", "flash_gqa_fwd_mma<128>"]),
    ("ssd_scan", ["ssd_cb<float>", "ssd_cb<__nv_bfloat16>",
                  "ssd_chunk_state<float>", "ssd_chunk_state<__nv_bfloat16>",
                  "ssd_chunk_scan<float>", "ssd_chunk_scan<__nv_bfloat16>"]),
])
def test_kernels_run_on_the_tensor_cores(card, kernel, functions):
    """The built library's SASS holds HMMA (or HGMMA) instructions in every
    function that computes a product."""
    from repro_torch.kernels import _build
    ops = _build.tensor_core_ops(kernel)
    if ops is None:
        pytest.skip("cuobjdump not found")
    for f in functions:
        got = [n for k, n in ops.items() if k.startswith(f"void {f}(")]
        assert got and all(n > 0 for n in got), (f, ops)


# ------------------------------------------------ routing by shape (C1)
def _dense_prefill(cfg, dev, params, tokens):
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import build_model
    bundle = build_model(cfg)
    logits, _ = make_prefill_step(bundle)(
        params, serve.prefill_batch(bundle, tokens.to(dev)))
    return logits.float().cpu()


@pytest.mark.cuda
def test_dense_layers_the_kernel_does_not_take_match_the_cpu(card):
    """A dense smoke model at head dim 24 prefills on the card through the
    plain path, one routed call a layer and no kernel launch, and equals
    the CPU's prefill in f32."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.modules import tree_map
    cfg = smoke_config("glm4-9b").replace(head_dim=24,
                                          compute_dtype=torch.float32)
    params, tokens = serve.random_request(cfg, 2, 64, 0, card)
    launches, routed = FK.launches, FK.routed
    got = _dense_prefill(cfg, card, params, tokens)
    assert FK.launches == launches
    assert FK.routed == routed + cfg.num_layers
    want = _dense_prefill(cfg, "cpu", tree_map(lambda t: t.cpu(), params),
                          tokens.cpu())
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", [(24, 24), (64, 32), (128, 64)])
def test_attend_routes_what_the_kernel_does_not_take(card, D, Dv):
    """``_attend`` with a head dim outside the kernel's, or v's head dim
    unlike k's: the plain path on the card, counted, equal to the CPU."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models import transformer as TT
    cfg = smoke_config("glm4-9b").replace(head_dim=D)
    H, Hkv = TT._heads(cfg)
    rng = np.random.default_rng(D + Dv)
    arrs = [rng.standard_normal((2, 96, h, d)).astype(np.float32)
            for h, d in ((H, D), (Hkv, D), (Hkv, Dv))]
    launches, routed = FK.launches, FK.routed
    got = TT._attend(cfg, *(torch.from_numpy(a).to(card) for a in arrs),
                     causal=True, window=0)
    assert (FK.launches, FK.routed) == (launches, routed + 1)
    want = TT._attend(cfg, *(torch.from_numpy(a) for a in arrs),
                      causal=True, window=0)
    assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ gradients (C2)
def _close_grads(got, want, tol=1e-3):
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())


def _layer_grads(apply, defs, names, dev, x_np, seed):
    """Gradients of sum(apply(p, x) * cotangent) in the parameters
    ``names``, with weights drawn on the CPU from ``seed``."""
    from repro_torch.models.modules import init_params, tree_map
    p = tree_map(lambda t: t.to(dev).requires_grad_(),
                 init_params(defs, torch.Generator().manual_seed(seed),
                             "cpu"), is_leaf=torch.is_tensor)
    x = torch.from_numpy(x_np).to(dev)
    out = apply(p, x)
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        out.shape).astype(np.float32)).to(dev)
    return torch.autograd.grad((out * cot).sum(), [p[n] for n in names])


@pytest.mark.cuda
def test_attention_gradients_through_flash_gqa_match_the_cpu(card):
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.modules import Sharder
    cfg = smoke_config("glm4-9b").replace(compute_dtype=torch.float32)
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)

    def apply(p, x):
        pos = torch.arange(x.shape[1], device=x.device)[None]
        return TT.attn_apply(cfg, p, x, Sharder(), positions=pos)[0]

    args = (apply, TT.attn_defs(cfg), ["wq", "wk", "wv"])
    before = FK.launches
    got = _layer_grads(*args, card, x, 6)
    assert FK.launches == before + 1
    _close_grads(got, _layer_grads(*args, "cpu", x, 6))


@pytest.mark.cuda
def test_mamba_gradients_through_ssd_scan_match_the_cpu(card):
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models import mamba2 as M
    from repro_torch.models.modules import Sharder
    cfg = smoke_config("mamba2-2.7b").replace(compute_dtype=torch.float32)
    x = np.random.default_rng(7).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    args = (lambda p, x: M.mamba_apply(cfg, p, x, Sharder())[0],
            M.mamba_defs(cfg), ["in_proj"])
    before = SK.launches
    got = _layer_grads(*args, card, x, 8)
    assert SK.launches == before + 1
    _close_grads(got, _layer_grads(*args, "cpu", x, 8))


@pytest.mark.cuda
def test_packed_row_gradients_match_the_cpu(card):
    """Float rows through ``pack`` (ids out of range, rows dropped past
    capacity) and through ``pack_by_key``: their gradients are the CPU
    plain version's, exactly; the int group gets none."""
    rng = np.random.default_rng(9)
    T = 5000
    rows_np = rng.standard_normal((T, 3)).astype(np.float32)
    ids_np = rng.integers(-1, 9, T).astype(np.int32)
    key_np = rng.integers(0, 1 << 40, T)
    cot = torch.from_numpy(rng.standard_normal((8, 1000, 3)).astype(
        np.float32))

    def grads(dev, by_key):
        rows = torch.from_numpy(rows_np).to(dev).requires_grad_()
        ints = torch.from_numpy(ids_np.astype(np.int64)[:, None]).to(dev)
        if by_key:
            key = torch.from_numpy(key_np).to(dev)
            if dev == "cpu":
                from repro_torch.relational.ops import partition_ids
                ids = partition_ids(key, 8)
                cap = int(torch.bincount(ids, minlength=8).max())
                (buf, ibuf), _, _ = K.plain_pack([rows, ints], ids, 8, cap)
            else:
                (buf, ibuf), _, _ = K.pack_by_key([rows, ints], key, 8)
        else:
            ids = torch.from_numpy(ids_np).to(dev)
            pack = K.plain_pack if dev == "cpu" else K.pack
            (buf, ibuf), _, _ = pack([rows, ints], ids, 8, 550)
        assert not ibuf.requires_grad
        c = cot[:, :buf.shape[1]].to(dev)
        (g,) = torch.autograd.grad((buf * c).sum(), rows)
        return g.cpu()

    for by_key in (False, True):
        before = K.launches
        got = grads(card, by_key)
        assert K.launches == before + 1
        assert torch.equal(got, grads("cpu", by_key))


# ------------------------------------------------ fixed-order sums (F3)
@pytest.mark.cuda
def test_float_aggregation_gives_the_same_bytes_every_run(card):
    """Group sums on the card add in a fixed order: the same inputs give
    the same bytes on every run, under deterministic algorithms too, and
    agree with the CPU's numpy-order sums at the oracle's tolerance."""
    from repro_torch.relational import ops
    from repro_torch.relational.table import Table
    rng = np.random.default_rng(11)
    n = 1_000_000
    for groups in (4, 3000):
        t = Table({"k": torch.from_numpy(rng.integers(0, groups, n)),
                   "v": torch.from_numpy(rng.random(n) * 1e5)})
        aggs = [("s", "sum", "v"), ("a", "avg", "v"), ("c", "count", None)]

        def run():
            out = ops.op_aggregate(t.to(card), ["k"], aggs)
            return {c: out[c].cpu() for c in ("s", "a", "c")}

        first = [run() for _ in range(3)]
        torch.use_deterministic_algorithms(True)
        try:
            first.append(run())
        finally:
            torch.use_deterministic_algorithms(False)
        for other in first[1:]:
            for c in ("s", "a", "c"):
                assert torch.equal(first[0][c].view(torch.int64),
                                   other[c].view(torch.int64)), c
        want = ops.op_aggregate(t, ["k"], aggs)
        for c in ("s", "a", "c"):
            assert torch.allclose(first[0][c], want[c], rtol=1e-9,
                                  atol=1e-6), c


@pytest.mark.cuda
@pytest.mark.parametrize("q", ["q12", "q3"])
def test_failover_replays_byte_identically_on_the_card(card, q):
    """A coordinator killed halfway through q12 or q3 fails over, and the
    replay passes the store's immutability audit (every re-PUT of a
    partial aggregate byte-identical); the result equals a run with no
    kill."""
    from repro_torch.core.session import Session
    from repro_torch.faults.journal import Journal
    opts = dict(sf=0.01, seed=3, compute_scale=0.0, device="cuda")
    journal = Journal()
    whole_s = Session(**opts)
    whole_s.coord.journal = journal
    whole = whole_s.submit(q)
    res, j = Session(**opts).run_with_failover(
        q, kill_after=journal.count // 2)
    assert j.frontier == journal.frontier
    assert (res.latency_s, res.cost) == (whole.latency_s, whole.cost)
    for c in whole.result.column_names():
        a, b = res.result[c], whole.result[c]
        a, b = getattr(a, "codes", a), getattr(b, "codes", b)
        assert torch.equal(a.cpu(), b.cpu()), c
