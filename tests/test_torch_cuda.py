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
from repro_torch.kernels.moe_combine import moe_combine as MK  # noqa: E402
from repro_torch.kernels.moe_combine import ops as mc_ops  # noqa: E402
from repro_torch.kernels.moe_combine import ref as mc_ref  # noqa: E402
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
    big = _flash_inputs(1, 64, 2, 2, 320, 1, card, torch.float32)
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
    # the wgmma body at (64, 64): S at a tile's edges and whisper's 1500
    # frames (its last kv tile of 28 rows), causal and with no mask; a
    # window that starts inside a kv tile; the padded map over a block
    # whose second warpgroup has no rows (S = 65) and over 4 query tiles
    *[(2, S, 4, 2, 64, causal, 0, None) for S in (1, 63, 65, 127, 129, 1500)
      for causal in (True, False)],
    (1, 300, 4, 2, 64, True, 100, None),
    (2, 200, 4, 2, 64, False, 37, None),
    (2, 65, 16, 4, 64, True, 0, SMOLLM_MAP),
    (4, 512, 16, 4, 64, True, 0, SMOLLM_MAP),
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


# whisper's cross attention at a decode step, at the prefill and around
# them: Sq of 1 to 200 against one key, a ragged kv tile, 1500 frames and
# more keys than 64 tiles (the wgmma body, Skv split where its blocks do
# not fill the card); and 288 items of 128 query rows, of which those past
# the first wave of two blocks an SM are split (on 132 SMs: 24 items, 11
# splits of one kv tile)
FLASH_WGMMA_CROSS = [(2, sq, skv, 6, 6, 64)
                     for sq in (1, 2, 16, 17, 64, 65, 200)
                     for skv in (1, 33, 1500, 4097)] + [
    (3, 1000, 700, 12, 4, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D", FLASH_WGMMA_CROSS)
def test_flash_gqa_bf16_cross_attention_edges(card, B, Sq, Skv, H, Hkv, D):
    """bf16 with no mask and Sq != Skv on the wgmma body, its kv split and
    merge included: within the bf16 tolerance of attention_ref; one launch
    a call. q is drawn at 3 times the unit scale, so that the softmax is
    sharp and the outputs are O(1), where the tolerance fails an output
    10 % off (asserted); at unit scale over 1500 keys they are about
    0.03 and it would not."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card) for shape in
        ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    assert FK.body(q.shape, v.shape, torch.bfloat16, causal=False) == "wgmma"
    before = FK.launches
    o = FK.flash_gqa(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FK.launches == before + 1 and o.shape == (B, Sq, H, D)
    m = torch.tensor([h // (H // Hkv) for h in range(H)], device=card)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=False)
    tol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    assert not torch.allclose(0.9 * want.float(), want.float(), rtol=tol,
                              atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 64, 1500])
def test_flash_gqa_wgmma_split_gives_the_same_bits_every_run(card, Sq):
    """whisper-tiny's cross attention at a decode step and at the prefill
    (B 4, 1 or 64 queries, 6 heads of 64, 1500 frames) and its encoder
    (1500 queries, whose items past the last full wave are split) split
    Skv on the wgmma body, and two calls give the same bits: the merge
    adds the splits in a fixed order."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card).bfloat16() for shape in
        ((4, Sq, 6, 64), (4, 1500, 6, 64), (4, 1500, 6, 64)))
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert FK.body(q.shape, v.shape, torch.bfloat16, causal=False) == "wgmma"
    assert FK.wgmma_split_plan(q.shape, v.shape, sms)[1] > 1
    first = FK.flash_gqa(q, k, v, causal=False)
    again = FK.flash_gqa(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,functions,kinds", [
    ("flash_gqa", ["flash_gqa_fwd_mma<16, 16>", "flash_gqa_fwd_mma<32, 32>",
                   "flash_gqa_fwd_mma<128, 128>"], ("HMMA", "HGMMA")),
    ("flash_gqa", ["flash_gqa_fwd_wgmma<64, 64>",
                   "flash_gqa_fwd_wgmma<192, 128>",
                   "flash_gqa_fwd_wgmma<256, 256>"], ("HGMMA",)),
    ("ssd_scan", ["ssd_cb<float>", "ssd_cb<__nv_bfloat16>",
                  "ssd_chunk_state<float>", "ssd_chunk_state<__nv_bfloat16>",
                  "ssd_chunk_scan<float>", "ssd_chunk_scan<__nv_bfloat16>"],
     ("HMMA", "HGMMA")),
], ids=["flash_gqa", "flash_gqa-wgmma", "ssd_scan"])
def test_kernels_run_on_the_tensor_cores(card, kernel, functions, kinds):
    """The built library's SASS holds HMMA (or HGMMA) instructions in every
    function that computes a product; the wgmma body's, at each of its
    pairs, wgmma's HGMMA."""
    from repro_torch.kernels import _build
    ops = _build.tensor_core_ops(kernel, kinds=kinds)
    if ops is None:
        pytest.skip("cuobjdump not found")
    for f in functions:
        # a template's demangled name carries its return type
        got = [n for k, n in ops.items() if k.startswith((f"void {f}(",
                                                          f"{f}("))]
        assert got and all(n > 0 for n in got), (f, ops)


# ------------------------------------------------ routing by shape (C1)
def _dense_prefill(cfg, dev, params, tokens, frames=None):
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import build_model
    bundle = build_model(cfg)
    logits, _ = make_prefill_step(bundle)(
        params, serve.prefill_batch(bundle, tokens.to(dev), frames))
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
    params, tokens, _ = serve.random_request(cfg, 2, 64, 0, card)
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


# ------------------------------------------------ MoE and MLA (deepseek)
# MLA's prefill pair (q/k 192, v 128): deepseek-v2-lite's prefill shape,
# ragged sequences around a 64-row tile, and a window
MLA_FLASH_CASES = [
    # B, S, H, D, Dv, causal, window
    (4, 512, 16, 192, 128, True, 0),
    (1, 1, 2, 192, 128, True, 0),
    (2, 65, 4, 192, 128, True, 0),
    (1, 200, 4, 192, 128, False, 0),
    (1, 130, 4, 192, 128, True, 24),
    # the wgmma body's edges at (192, 128): S past one or two kv tiles,
    # 1500 rows with and without a mask, a window inside a kv tile
    (2, 63, 4, 192, 128, True, 0),
    (2, 127, 4, 192, 128, True, 0),
    (1, 129, 4, 192, 128, True, 0),
    (1, 1500, 4, 192, 128, True, 0),
    (1, 1500, 4, 192, 128, False, 0),
    (1, 300, 4, 192, 128, True, 100),
    (2, 65, 4, 192, 128, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,Dv,causal,window", MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_kernel_with_v_head_dim_unlike_k(card, B, S, H, D, Dv,
                                                   causal, window, dtype):
    """The (192, 128) instantiation of both bodies against attention_ref:
    2e-5 in f32, 2e-2 (one bf16 step of the output) in bf16; the output
    has v's head dim."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card).to(dt) for shape in
        ((B, S, H, D), (B, S, H, D), (B, S, H, Dv)))
    before = FK.launches
    o = FK.flash_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.launches == before + 1
    assert o.dtype == dt and o.shape == (B, S, H, Dv)
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


# MoE dispatch: deepseek-v2-lite's prefill (4 x 512 tokens, top 6 of 64,
# capacity 72) and decode (4 tokens, capacity 8) shapes, and a hot expert
# with capacity drops
DISPATCH_CASES = [
    # B, S, E, k, capacity_factor, hot
    (4, 512, 64, 6, 1.5, False),
    (4, 1, 64, 6, 1.5, False),
    (2, 256, 64, 6, 0.25, True),
    (3, 40, 4, 2, 1.5, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,E,k,capacity_factor,hot", DISPATCH_CASES)
def test_moe_dispatch_through_pack_equals_dispatch_indices(
        card, B, S, E, k, capacity_factor, hot):
    """One ``pack`` call over B·E ids places every entry where the plain
    per-group ``dispatch_indices`` does, bit for bit, dropped entries
    included; the expert-major buffer [E, B·C, d] equals the CPU's plain
    pack exactly and holds each kept entry's token row at expert e's row
    b·C + slot."""
    from repro_torch.models import moe as TM
    C = TM.expert_capacity(S, E, k, capacity_factor)
    rng = np.random.default_rng(S + E)
    e = rng.integers(0, E, (B * S, k)).astype(np.int32)
    if hot:
        e[rng.random((B * S, k)) < 0.5] = E - 1
    h = torch.from_numpy(rng.standard_normal((B, S, 2048)).astype(
        np.float32)).to(torch.bfloat16)
    before = K.launches
    buf, ids, slots = TM.dispatch(h.to(card), torch.from_numpy(e).to(card),
                                  E, C)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want_buf, want_ids, want_slots = TM.dispatch(h, torch.from_numpy(e), E,
                                                 C)
    assert torch.equal(ids.cpu(), want_ids)
    assert torch.equal(slots.cpu(), want_slots)
    assert buf.shape == (E, B * C, 2048)
    assert torch.equal(buf.cpu(), want_buf)
    flat = slots.cpu().long()
    kept = flat < C
    entry_b = torch.arange(B * S * k) // (S * k)
    entry_e = torch.from_numpy(e.reshape(-1)).long()
    assert torch.equal(
        want_buf[entry_e[kept], entry_b[kept] * C + flat[kept]],
        h.reshape(B * S, -1)[torch.arange(B * S * k)[kept] // k])
    slots = slots.cpu().view(B, S * k)
    dropped = 0
    for b in range(B):
        eb = torch.from_numpy(e[b * S:(b + 1) * S].reshape(-1))
        sort_idx, dest, keep, _ = TM.dispatch_indices(eb, E, C)
        got = torch.where(slots[b] < C, eb * C + slots[b], E * C)
        assert torch.equal(got[sort_idx.long()].int(), dest)
        assert torch.equal(slots[b][sort_idx.long()] < C, keep)
        dropped += int((~keep).sum())
    if capacity_factor < 1:
        assert dropped > 0


def _deepseek_cfg(mla_dims: bool):
    """deepseek-v2-lite's smoke config in f32; with ``mla_dims`` its MLA
    head dims are the published ones (q/k 128 + 64, v 128), which the
    kernel takes, else the smoke config's 16 + 8 and 16, which it does
    not."""
    from repro_torch.configs.smoke import smoke_config
    cfg = smoke_config("deepseek-v2-lite-16b").replace(
        compute_dtype=torch.float32)
    if mla_dims:
        cfg = cfg.replace(qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128, head_dim=192)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("mla_dims", [False, True],
                         ids=["smoke-dims", "mla-dims"])
def test_deepseek_prefill_on_the_card_matches_the_cpu(card, mla_dims):
    """A deepseek smoke model prefills on the card with one pack and one
    combine a MoE layer and its MLA attention on the kernel (at the
    published head dims) or routed to the plain path (at the smoke
    config's), and equals the CPU's prefill in f32."""
    from repro_torch.launch import serve
    from repro_torch.models.modules import tree_map
    cfg = _deepseek_cfg(mla_dims)
    params, tokens, _ = serve.random_request(cfg, 2, 64, 0, card)
    launches = FK.launches, FK.routed, K.launches, MK.launches
    got = _dense_prefill(cfg, card, params, tokens)
    n_moe = cfg.num_layers - cfg.moe.first_dense
    attn = (cfg.num_layers, 0) if mla_dims else (0, cfg.num_layers)
    assert (FK.launches - launches[0], FK.routed - launches[1]) == attn
    assert K.launches == launches[2] + n_moe
    assert MK.launches == launches[3] + n_moe
    want = _dense_prefill(cfg, "cpu", tree_map(lambda t: t.cpu(), params),
                          tokens.cpu())
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)


# moe_combine: the two MoE cells' shapes (bench/, a batch of 4 x 4096 of
# deepseek-v2-lite-16b.prefill_long: 64 experts, top 6, d 2048; 8 x 4096 of
# granite-4.0-h-small.prefill_longdoc: 36 of 72 experts held here, top 10,
# d 4096), llama4's top 1 at its width 5120, heavy drops, and rows of a
# few 16-byte vectors (fewer than a warp's lanes)
COMBINE_CASES = [
    # B, S, experts routed, held, k, d, capacity factor, dtype
    (4, 4096, 64, 64, 6, 2048, 1.5, "bfloat16"),
    (8, 4096, 72, 36, 10, 4096, 1.5, "bfloat16"),
    (2, 256, 16, 16, 1, 5120, 1.0, "bfloat16"),
    (3, 40, 4, 4, 2, 64, 0.25, "float32"),
    (2, 64, 24, 12, 10, 40, 1.0, "bfloat16"),
    (2, 64, 24, 12, 10, 36, 1.0, "float32"),
]


def _combine_inputs(card, B, S, E, held, k, d, capacity_factor, dtype,
                    seed=0):
    """A combine's inputs as the model hands them over: ids and slots
    from ``dispatch`` (expert 0 hot, so its partitions fill and drop;
    entries of experts past ``held`` at slot C), eout [held, B*C, d] and
    router weights drawn from ``seed``; token 0's entries all dropped,
    and NaN and Inf in the row of a kept entry at a partition's last
    slot, which is then dropped (only dropped entries read that row)."""
    from repro_torch.models import moe as TM
    dt = getattr(torch, dtype)
    C = TM.expert_capacity(S, E, k, capacity_factor)
    gen = torch.Generator(card).manual_seed(seed)
    scores = torch.randn(B * S, E, generator=gen, device=card)
    scores[:, 0] += 3 * (torch.rand(B * S, generator=gen, device=card) < 0.5)
    experts = torch.topk(scores, k).indices.to(torch.int32)
    _, ids, slots = TM.dispatch(torch.zeros(B, S, 8, device=card), experts,
                                E, C, first=0, n_held=held)
    eout = torch.randn(held, B * C, d, generator=gen, device=card).to(dt)
    w = torch.rand(B * S, k, generator=gen, device=card).to(dt)
    slots[:k] = C
    last = int(torch.nonzero(slots == C - 1)[0])
    slots[last] = C
    row = eout.view(-1, d)[int(ids[last]) * C + C - 1]
    row.fill_(float("nan"))
    row[0] = float("inf")
    return eout, ids, slots, w, C


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,E,held,k,d,capacity_factor,dtype",
                         COMBINE_CASES)
def test_moe_combine_kernel_matches_plain(card, B, S, E, held, k, d,
                                          capacity_factor, dtype):
    """One launch gives the kernel's documented order in plain PyTorch on
    the card (``ref.combine_in_order``) bit for bit, and the plain combine
    (PyTorch's sum over k, in another order) within one step of the last
    place at the terms' scale in bf16 (``ref.term_step``; k - 1 such steps
    in f32); finite where a dropped entry's row holds NaN and Inf, zero for
    a token with every entry dropped."""
    eout, ids, slots, w, C = _combine_inputs(card, B, S, E, held, k, d,
                                             capacity_factor, dtype)
    assert bool((slots >= C).any()) and bool((slots < C).any())
    before = MK.launches
    with torch.inference_mode():
        got = mc_ops.moe_combine(eout, ids, slots, w, C, S, k)
    torch.cuda.synchronize()
    assert MK.launches == before + 1
    assert got.shape == (B, S, d) and got.dtype == eout.dtype
    assert torch.isfinite(got).all()
    assert not got[0, 0].any()
    assert torch.equal(got, mc_ref.combine_in_order(eout, ids, slots, w, C,
                                                    S, k))
    want = mc_ref.combine(eout, ids, slots, w, C, S, k)
    steps = 1 if dtype == "bfloat16" else k - 1
    step = mc_ref.term_step(eout, ids, slots, w, C, S, k)
    assert bool(((got.float() - want.float()).abs() <= steps * step).all())


@pytest.mark.cuda
def test_moe_combine_refuses_what_it_does_not_take(card):
    """Rows that are no whole number of 16-byte vectors, more entries a
    token than a warp's lanes, ids of another type: refused, nothing
    launched."""
    eout, ids, slots, w, C = _combine_inputs(card, 2, 64, 8, 8, 2, 64, 1.0,
                                             "bfloat16")
    before = MK.launches
    with pytest.raises(ValueError, match="16-byte"):
        MK.combine(eout[..., :36].contiguous(), ids, slots, w, C, 64, 2)
    with pytest.raises(ValueError, match="entries a token"):
        MK.combine(eout, ids.repeat(17), slots.repeat(17), w.repeat(1, 17),
                   C, 64, 34)
    with pytest.raises(ValueError, match="int32"):
        MK.combine(eout, ids.long(), slots, w, C, 64, 2)
    assert MK.launches == before


@pytest.mark.cuda
def test_moe_combine_gives_the_same_bits_every_run(card):
    eout, ids, slots, w, C = _combine_inputs(card, *COMBINE_CASES[1][:-1],
                                             "bfloat16", seed=1)
    S, k = COMBINE_CASES[1][1], COMBINE_CASES[1][4]
    with torch.inference_mode():
        a = mc_ops.moe_combine(eout, ids, slots, w, C, S, k)
        b = mc_ops.moe_combine(eout, ids, slots, w, C, S, k)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_layer_gradients_through_moe_combine_are_the_plain_paths(
        card, monkeypatch, dtype):
    """A deepseek smoke MoE layer (capacity factor 0.5: entries drop) on
    the card: the gradients of every parameter and of the input through
    the kernel's call equal those with the plain combine in the kernel's
    place, bit for bit (the loss is linear in the layer's output, whose
    cotangent is then the same in both)."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import moe as TM
    from repro_torch.models.modules import Sharder, tree_leaves, tree_map
    import dataclasses
    cfg = smoke_config("deepseek-v2-lite-16b")
    cfg = cfg.replace(compute_dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    params, _, _ = serve.random_request(cfg, 2, 64, 3, card)
    p = tree_map(lambda t: t[0], params["layers"]["mlp"])
    gen = torch.Generator(card).manual_seed(4)
    x = torch.randn(2, 64, cfg.d_model, generator=gen, device=card).to(dtype)
    cot = torch.randn(2, 64, cfg.d_model, generator=gen, device=card)

    def grads():
        ps = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        xs = x.detach().clone().requires_grad_()
        out, _ = TM.moe_apply(cfg, ps, xs, Sharder(None, None))
        leaves = [xs, *tree_leaves(ps, torch.is_tensor)]
        return torch.autograd.grad((out.float() * cot).sum(), leaves)

    before = MK.launches
    got = grads()
    assert MK.launches == before + 1
    monkeypatch.setattr(TM, "combine", mc_ref.combine)
    want = grads()
    assert MK.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


# ------------------------- head dim 256, cross attention (griffin, whisper)
# recurrentgemma-9b's (256, 256): 16 q heads over 1 kv head, causal, with
# its window of 2048 at S = 4096 and a window narrower than a tile, ragged
# S around a tile and one row; whisper's cross attention (Sq != Skv, no
# mask, 6 heads of 64) at the prefill (64 queries) and decode (1 query)
# against 1500 frames, and its encoder (S = 1500, no mask)
FLASH_256_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window
    (4, 512, 512, 16, 1, 256, True, 0),
    (1, 4096, 4096, 16, 1, 256, True, 2048),
    (1, 1, 1, 2, 1, 256, True, 0),
    (1, 65, 65, 4, 1, 256, True, 0),
    (2, 130, 130, 4, 2, 256, False, 24),
    (1, 200, 200, 16, 1, 256, False, 0),
    # the wgmma body's edges: S past a multiple of 64 or 128 (its last kv
    # tile and its second warpgroup's rows ragged), a window that starts
    # inside a kv tile, a block whose two warpgroups end 64 rows apart
    (1, 4097, 4097, 2, 1, 256, True, 0),
    (2, 130, 130, 4, 2, 256, True, 0),
    (1, 300, 300, 4, 2, 256, True, 100),
    (1, 1000, 1000, 6, 3, 256, True, 300),
    (1, 200, 200, 2, 2, 256, True, 0),
]
FLASH_CROSS_CASES = [
    (4, 64, 1500, 6, 6, 64, False, 0),
    (4, 1, 1500, 6, 6, 64, False, 0),
    (4, 1500, 1500, 6, 6, 64, False, 0),
    (2, 100, 33, 4, 2, 128, False, 0),
    (2, 130, 64, 4, 1, 256, False, 0),
    (1, 7, 200, 16, 4, 16, False, 0),
    # the split body (Sq <= 16) and the tiled one just above it, against
    # one key, a ragged split, whisper's frames and more keys than 32
    # splits of 128
    *[(2, sq, skv, 6, 6, 64, False, 0) for sq in (1, 2, 16, 17)
      for skv in (1, 33, 1500, 4097)],
    (1, 2, 4097, 4, 1, 256, False, 0),
    (2, 16, 1500, 16, 4, 128, False, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window",
                         FLASH_256_CASES + FLASH_CROSS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_head_dim_256_and_cross_attention(card, B, Sq, Skv, H, Hkv,
                                                    D, causal, window,
                                                    dtype):
    """Head dim 256 (bf16: the wgmma body, S once a kv tile for each
    64-row group; f32: two 128-column halves of the output a (b, h, tile),
    S recomputed for each) and Sq != Skv with no mask (Sq <= 16: the split
    body; above: the tiled bodies): 2e-5 in f32, 2e-2 in bf16 against
    attention_ref over k/v gathered by the map; rows past Sq are never
    written and keys past Skv count for nothing."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card).to(dt) for shape in
        ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = FK.launches
    o = FK.flash_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.launches == before + 1
    assert o.dtype == dt and o.shape == (B, Sq, H, D)
    m = torch.tensor([h // (H // Hkv) for h in range(H)], device=card)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,kv_head", [
    (2, 200, 200, 4, 2, 256, True, (1, 0, 0, 1)),
    (1, 130, 130, 3, 2, 256, True, (1, 1, 0)),
    (2, 5, 1500, 16, 4, 64, False,
     (0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0)),
])
def test_flash_gqa_irregular_map_in_the_new_bodies(card, B, Sq, Skv, H, Hkv,
                                                   D, causal, kv_head,
                                                   dtype):
    """An irregular head map (no h // rep; smollm-135m's padded heads read
    kv head 0) in the wgmma body at head dim 256 and in the split body,
    whose block gathers every query head of its kv head: 2e-5 in f32, 2e-2
    in bf16 against attention_ref over k/v gathered by the map."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(Sq + Skv + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card).to(dt) for shape in
        ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    o = FK.flash_gqa(q, k, v, causal=causal, kv_head=kv_head)
    torch.cuda.synchronize()
    m = torch.tensor(kv_head, device=card)
    want = attention_ref(q, k.index_select(2, m), v.index_select(2, m),
                         causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_split_body_gives_the_same_bits_every_run(card, dtype):
    """The split body at whisper-tiny's decode cross attention (B 4, 6
    heads of 64, one query against 1500 frames; f32 takes it, bf16 takes
    the wgmma body and the split body only by name) has at least one
    first-pass block an SM, and two calls give the same bits: the merge
    adds the splits in a fixed order, with no atomics."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card).to(dt) for shape in
        ((4, 1, 6, 64), (4, 1500, 6, 64), (4, 1500, 6, 64)))
    assert FK.body(q.shape, v.shape, dt, causal=False) == (
        "split" if dtype == "float32" else "wgmma")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    n_split, _ = FK.split_plan(4, 1500, 6, sms)
    assert n_split * 4 * 6 >= sms
    kw = dict(causal=False, window=0, kv_head=None, which="split")
    first = FK._launch(q, k, v, **kw)
    assert FK.last_launch() == FK.BODY_KERNELS["split"]
    again = FK._launch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,dtype", [
    (1, 1, 1500, 6, 6, 64, False, "bfloat16"),
    (1, 1, 1500, 6, 6, 64, False, "float32"),
    (1, 128, 128, 4, 1, 256, True, "bfloat16"),
    (1, 128, 128, 4, 1, 256, True, "float32"),
    (1, 128, 128, 4, 2, 128, True, "bfloat16"),
    (1, 1500, 1500, 6, 6, 64, False, "bfloat16"),
    (4, 64, 1500, 6, 6, 64, False, "bfloat16"),
    (1, 128, 128, 4, 4, 192, True, "bfloat16"),
    (1, 128, 128, 4, 2, 32, True, "bfloat16"),
])
def test_flash_gqa_runs_the_body_it_names(card, B, Sq, Skv, H, Hkv, D,
                                          causal, dtype):
    """The CUDA functions a call launches are those of the body
    ``flash_gqa.body`` names for its shapes (the wgmma body's merge only
    where it splits Skv), and nothing else: as the driver recorded them
    in a CUDA graph of the call (``kernels/_graph.launched_functions``,
    which observes the launches; torch.profiler's kernel records came
    back empty on the card in a process that had run the other tests),
    and as the source's dispatch records them (``flash_gqa.last_launch``,
    in launch order)."""
    from repro_torch.kernels._graph import launched_functions
    dt = getattr(torch, dtype)
    Dv = 128 if D == 192 else D
    q, k, v = (torch.zeros(shape, device=card, dtype=dt) for shape in
               ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)))
    FK.flash_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    which = FK.body(q.shape, v.shape, dt, causal=causal)
    want = FK.BODY_KERNELS[which]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    if which == "wgmma" and (causal or FK.wgmma_split_plan(
            q.shape, v.shape, sms)[1] == 1):
        want = want[:1]
    assert FK.last_launch() == want
    ran = launched_functions(lambda: FK.flash_gqa(q, k, v, causal=causal))
    assert sorted(ran) == sorted(want), ran


@pytest.mark.cuda
def test_flash_gqa_refuses_a_query_offset(card):
    """Sq != Skv in a causal or windowed call would need a query offset,
    which the kernel does not have: refused before any launch."""
    q, k, v = _flash_inputs(1, 64, 4, 2, 64, 1, card, torch.float32)
    before = FK.launches
    for kw in ({"causal": True}, {"causal": False, "window": 16}):
        with pytest.raises(ValueError, match="Sq == Skv"):
            FK.flash_gqa(q[:, :32].contiguous(), k, v, **kw)
    assert FK.launches == before


# the three families this slice serves, at their smoke configs in f32:
# the prompt is longer than griffin's window (8) and than llama4's chunk
# (8); the kernels each prefill must launch
FAMILY_LAUNCHES = {
    # arch: (flash_gqa, partition_pack) a prefill
    "recurrentgemma-9b": (1, 0),           # one (rec, rec, attn) triple
    "whisper-tiny": (6, 0),                # 2 encoder, 2 self, 2 cross
    "llama4-maverick-400b-a17b": (4, 2),   # 4 sub-layers, 2 of them MoE
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_new_family_prefill_on_the_card_matches_the_cpu(card, arch):
    """Each new family's smoke model prefills on the card with every
    attention call on flash_gqa (none routed) and llama4's MoE dispatch on
    partition_pack, and equals the CPU's prefill in f32."""
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.modules import tree_map
    cfg = smoke_config(arch).replace(compute_dtype=torch.float32)
    params, tokens, frames = serve.random_request(cfg, 2, 64, 0, card)
    before = FK.launches, FK.routed, K.launches
    got = _dense_prefill(cfg, card, params, tokens, frames)
    flash, pack = FAMILY_LAUNCHES[arch]
    assert (FK.launches - before[0], FK.routed - before[1],
            K.launches - before[2]) == (flash, 0, pack)
    want = _dense_prefill(cfg, "cpu", tree_map(lambda t: t.cpu(), params),
                          tokens.cpu(), frames)
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)


# -------------------------------------------------------------- training
# one train step of each family at its smoke config in f32 (deepseek at
# the published MLA head dims, which the kernel takes), B = 2, S = 64: the
# launches of the step as launch/steps.py:train_launches works them out,
# and card against CPU
TRAIN_ARCHS = ("deepseek-v2-lite-16b", "glm4-9b",
               "llama4-maverick-400b-a17b", "mamba2-2.7b", "qwen2-vl-7b",
               "recurrentgemma-9b", "whisper-tiny")
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-3


def _train_case(arch, dev):
    """(bundle, params, batch) of ``arch``'s smoke config on ``dev``, the
    same numbers on every device."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.models.modules import init_params, tree_map
    cfg = (_deepseek_cfg(True) if arch == "deepseek-v2-lite-16b"
           else smoke_config(arch))
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs, torch.Generator().manual_seed(0),
                         "cpu")
    batch = init_params(bundle.batch_defs(ShapeConfig("t", 64, 2, "train")),
                        None, "cpu")
    rng = np.random.default_rng(1)
    for k in ("tokens", "targets"):
        batch[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
    if "frames" in batch:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            batch["frames"].shape).astype(np.float32))
    move = lambda t: tree_map(lambda x: x.to(dev), t, is_leaf=torch.is_tensor)
    return bundle, move(params), move(batch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    from repro_torch.launch.steps import (grads_of, make_train_step,
                                          train_launches)
    from repro_torch.models.modules import tree_leaves
    from repro_torch.runtime.optimizer import make_optimizer
    (bundle, pc, bc), (_, pg, bg) = (_train_case(arch, "cpu"),
                                     _train_case(arch, card))
    (gc, mc), (gg, mg) = (grads_of(bundle.loss_fn, pc, bc),
                          grads_of(bundle.loss_fn, pg, bg))
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        TRAIN_LOSS_TOL * abs(float(mc["loss"]))
    for a, b in zip(tree_leaves(gg, torch.is_tensor),
                    tree_leaves(gc, torch.is_tensor), strict=True):
        a = a.cpu()
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= TRAIN_GRAD_TOL * float(
            b.abs().max())
    # one step on the card: the kernels as worked out, none routed
    opt = make_optimizer(bundle.cfg.optimizer)
    state = {"params": pg, "opt": opt.init(pg),
             "step": torch.zeros((), dtype=torch.int32, device=card)}
    before = FK.launches, SK.launches, K.launches, FK.routed, MK.launches
    state, m = make_train_step(bundle, opt)[0](state, bg)
    torch.cuda.synchronize()
    assert {"flash_gqa": FK.launches - before[0],
            "ssd_scan": SK.launches - before[1],
            "partition_pack": K.launches - before[2],
            "moe_combine": MK.launches - before[4]} == train_launches(
                bundle.cfg)
    assert FK.routed == before[3]
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))


# ------------------------------------------------------- elastic training
# runtime/train_loop.ElasticTrainer on the card at the smoke configs of the
# two elastic cells of chip_smoke.py: a clean run and a run whose workers
# die at (task 1, step 3) and (task 2, step 4) must log the same losses bit
# for bit, each kernel launched train_launches times a step the run ran
ELASTIC_ARCHS = ("mamba2-2.7b", "smollm-135m")


def _elastic_run(arch, dev, fails):
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.objectstore.store import ObjectStore, StoreConfig
    from repro_torch.runtime.train_loop import ElasticTrainer, JobConfig
    left = set(fails)

    def hook(task, step):
        if (task, step) in left:
            left.discard((task, step))
            return True
        return False
    trainer = ElasticTrainer(
        build_model(smoke_config(arch)),
        ObjectStore(StoreConfig(seed=0, simulate_visibility_lag=False)),
        JobConfig(steps_per_task=2, total_steps=8, batch=4, seq=64),
        failure_hook=hook, device=dev)
    steps, step_fn = [], trainer.step_fn
    trainer.step_fn = lambda s, b: (steps.append(1), step_fn(s, b))[1]
    before = FK.launches, SK.launches, K.launches, FK.routed, MK.launches
    log = trainer.run()
    torch.cuda.synchronize()
    launched = {"flash_gqa": FK.launches - before[0],
                "ssd_scan": SK.launches - before[1],
                "partition_pack": K.launches - before[2],
                "moe_combine": MK.launches - before[4]}
    assert not left and FK.routed == before[3]
    return log, launched, len(steps), trainer.bundle.cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ELASTIC_ARCHS)
def test_elastic_trainer_recovers_bit_exact_on_the_card(card, arch):
    from repro_torch.launch.steps import train_launches
    clean, n_clean, steps_clean, cfg = _elastic_run(arch, card, ())
    recov, n_recov, steps_recov, _ = _elastic_run(arch, card,
                                                  ((1, 3), (2, 4)))
    assert [m["step"] for m in clean] == [m["step"] for m in recov] == \
        [2, 4, 6, 8]
    assert all(np.isfinite(m["loss"]) for m in clean)
    np.testing.assert_allclose([m["loss"] for m in recov],
                               [m["loss"] for m in clean], rtol=0, atol=0)
    per_step = train_launches(cfg)
    assert (steps_clean, steps_recov) == (8, 9)
    assert n_clean == {k: v * 8 for k, v in per_step.items()}
    assert n_recov == {k: v * 9 for k, v in per_step.items()}


@pytest.mark.cuda
def test_checkpoint_from_the_card_restores_on_the_cpu(card):
    """A tree of f32, int32 and bf16 tensors saved from the card restores
    on the CPU to the same bits, full and as the template's dtypes."""
    from repro_torch.models.modules import tree_leaves
    from repro_torch.objectstore.store import ObjectStore, StoreConfig
    from repro_torch.runtime.checkpoint import CheckpointManager
    g = torch.Generator(card).manual_seed(0)
    state = {"w": torch.randn(37, 5, generator=g, device=card),
             "b": [torch.randn(3, generator=g, device=card).bfloat16(),
                   torch.arange(7, dtype=torch.int32, device=card)],
             "step": torch.tensor(3, dtype=torch.int32, device=card)}
    ck = CheckpointManager(ObjectStore(StoreConfig(
        seed=0, simulate_visibility_lag=False)), "m", n_shards=4)
    assert ck.save(state, 1)[0]
    got, _ = ck.restore_state(state, 1)
    for a, b in zip(tree_leaves(got, torch.is_tensor),
                    tree_leaves(state, torch.is_tensor), strict=True):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b.cpu())


# one train step's gradients twice from one state on the card: the same
# bits. glm4-9b's smoke layers at its published heads (32 q over 2 kv, so
# the kv gathers take more than 16 indices, above which index_add_ adds by
# atomics in no fixed order) and deepseek's (the MoE dispatch gathers
# B·E·C rows); kernels/_autograd.py:index_select adds in a fixed order
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "glm4-9b"])
def test_train_step_gives_the_same_bits_every_run(card, arch):
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.launch.steps import grads_of
    from repro_torch.models.model import build_model
    from repro_torch.models.modules import init_params, tree_leaves
    cfg = (_deepseek_cfg(True) if arch == "deepseek-v2-lite-16b" else
           smoke_config(arch).replace(num_heads=32, num_kv_heads=2))
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs,
                         torch.Generator(card).manual_seed(0), card)
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 65)).astype(np.int32)).to(card)
    batch = {"tokens": seq[:, :-1].contiguous(),
             "targets": seq[:, 1:].contiguous(),
             "mask": torch.ones(4, 64, dtype=torch.int32, device=card)}
    runs = [tree_leaves(grads_of(bundle.loss_fn, params, batch)[0],
                        torch.is_tensor) for _ in range(3)]
    for later in runs[1:]:
        for a, b in zip(runs[0], later, strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_step_analysis_of_the_card_matches_its_meta_dry_run(card):
    """Step 1 of chip_smoke.py's [dryrun] phase at one step: smollm-135m's
    train step at full width and depth (B 4, S 512, f32 parameters and
    AdamW state, bf16 compute) analyzed on the card and on meta tensors
    (launch/dryrun.card_check): the same FLOPs and kernel calls, HBM
    bytes within 1 %, the meta peak within 10 % of the card's
    max_memory_allocated, and so the step's own peak above its arguments
    (above what the card held before it)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.dryrun import card_check
    cfg = get_config("smollm-135m").replace(param_dtype=torch.float32,
                                            compute_dtype=torch.bfloat16)
    r = card_check(cfg, ShapeConfig("train", 512, 4, "train"), card,
                   timed=1)
    c, m = r["card"], r["meta"]
    assert c["flops"] == m["flops"] > r["model_flops"] > 0
    assert c["kernel_calls"] == m["kernel_calls"] == {"flash_gqa": 60}
    assert abs(c["memory_bytes"] - m["memory_bytes"]) \
        <= 0.01 * m["memory_bytes"]
    assert abs(m["peak_bytes"] - r["card_peak_bytes"]) \
        <= 0.10 * r["card_peak_bytes"]
    own_card = r["card_peak_bytes"] - r["allocated_before"]
    own_meta = m["peak_bytes"] - m["argument_bytes"]
    assert abs(own_meta - own_card) <= 0.10 * own_card


# flash_gqa's backward (kernels/flash_gqa/flash_gqa.py:grads): the model's
# attention differentiated chunk by chunk (the causal split at the smoke
# chunk, a window, cross attention) at glm4-9b's published heads (32 q
# over 2 kv, so the kv gathers' gradients add more than 16 rows an index)
@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal,window,impl,chunk", [
    (256, 256, True, 0, "block_tri", 64), (200, 200, True, 48, "block_tri",
                                           64),
    (48, 300, False, 0, "block_tri", 32)])
def test_flash_gqa_backward_gives_the_same_bits_every_run(
        card, Sq, Skv, causal, window, impl, chunk):
    """Three runs of the backward on the card give the same bits (C5),
    within 1e-3 of the CPU's in f32, of each gradient's largest entry."""
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, Sq, 32, 64), (2, Skv, 2, 64), (2, Skv, 2, 64)))
    go = torch.from_numpy(rng.standard_normal((2, Sq, 32, 64))
                          .astype(np.float32))
    kw = dict(causal=causal, window=window, impl=impl, chunk=chunk)
    want = FK.grads(q, k, v, go, **kw)
    runs = []
    for _ in range(3):
        xs = [t.to(card).requires_grad_() for t in (q, k, v)]
        o = FK.flash_gqa(*xs, causal=causal, window=window, impl=impl,
                         chunk=chunk)
        runs.append(torch.autograd.grad(o, xs, go.to(card)))
    for later in runs[1:]:
        for a, b in zip(runs[0], later, strict=True):
            assert torch.equal(a, b)
    for a, b in zip(runs[0], want, strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


@pytest.mark.cuda
def test_smollm_train_gradients_at_full_width_match_the_cpu(card):
    """One train step's gradients of smollm-135m at full width and depth
    (30 layers, f32 parameters and compute, remat, B 2 x S 256) on the
    card, through flash_gqa and its chunk-by-chunk backward, within 1e-3
    of the CPU's (the reference's attention algorithm), of each leaf's
    largest entry; the loss within 1e-5."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import grads_of
    from repro_torch.models.model import build_model
    from repro_torch.models.modules import init_params, tree_leaves, tree_map
    cfg = get_config("smollm-135m").replace(param_dtype=torch.float32,
                                            compute_dtype=torch.float32)
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs, torch.Generator().manual_seed(0),
                         "cpu")
    seq = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 257)).astype(np.int32))
    batch = {"tokens": seq[:, :-1].contiguous(),
             "targets": seq[:, 1:].contiguous(),
             "mask": torch.ones(2, 256, dtype=torch.int32)}
    move = lambda t: tree_map(lambda x: x.to(card), t,  # noqa: E731
                              is_leaf=torch.is_tensor)
    gc, mc = grads_of(bundle.loss_fn, params, batch)
    before = FK.launches
    gg, mg = grads_of(bundle.loss_fn, move(params), move(batch))
    torch.cuda.synchronize()
    assert FK.launches - before == 2 * cfg.num_layers
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        TRAIN_LOSS_TOL * abs(float(mc["loss"]))
    for a, b in zip(tree_leaves(gg, torch.is_tensor),
                    tree_leaves(gc, torch.is_tensor), strict=True):
        a = a.cpu()
        assert torch.isfinite(a).all() and float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= TRAIN_GRAD_TOL * float(
            b.abs().max())
