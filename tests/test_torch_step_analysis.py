"""The port's step analysis (``repro_torch.launch.step_analysis``) against
closed forms and the JAX package's ``hlo_analysis.analyze``: the three
cases of tests/test_hlo_analysis.py (a loop of products, nested loops,
gradients), collective bytes by the ring model on a 2x4 fake mesh, a
kernel entry on meta counting its ``work`` and nothing inside it, the
kernels' ``work`` against the bounds chip_smoke.py printed before it
called them, and the live-bytes high-water mark."""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import meshes  # noqa: E402,F401
from repro.launch.hlo_analysis import analyze as hlo_analyze  # noqa: E402
from repro_torch.kernels.flash_gqa import ops as flash_ops  # noqa: E402
from repro_torch.kernels.partition_pack import ops as pp_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.step_analysis import BLOCK, analyze  # noqa: E402


def _hlo(f, *args):
    return hlo_analyze(jax.jit(f).lower(*args).compile().as_text(), 1)


def test_loop_of_products_matches_closed_form_and_reference():
    def unrolled(w, x):
        for i in range(8):
            x = torch.tanh(x @ w[i])
        return x.sum()

    def scanned(w, x):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        y, _ = jax.lax.scan(body, x, w)
        return y.sum()

    expect = 2.0 * 256 * 512 * 512 * 8
    _, got = analyze(unrolled, torch.zeros(8, 512, 512),
                     torch.zeros(256, 512))
    assert got["flops"] == expect
    ref = _hlo(scanned, jnp.zeros((8, 512, 512)), jnp.zeros((256, 512)))
    assert abs(got["flops"] - ref["flops"]) <= 0.05 * ref["flops"]


def test_nested_loops():
    def f(w, x):
        return sum((xi @ w[j]).sum() for j in range(4) for xi in x)

    def g(w, x):
        def outer(c, wi):
            return c, jax.lax.map(lambda xi: xi @ wi, c)
        return jax.lax.scan(outer, x, w)[1].sum()

    expect = 2.0 * 32 * 128 * 128 * 6 * 4
    _, got = analyze(f, torch.zeros(4, 128, 128), torch.zeros(6, 32, 128))
    assert got["flops"] == expect
    ref = _hlo(g, jnp.zeros((4, 128, 128)), jnp.zeros((6, 32, 128)))
    assert abs(got["flops"] - ref["flops"]) <= 0.05 * ref["flops"]


def test_grad_flops():
    def loss(w, x):
        return ((x @ w) ** 2).sum()

    def jloss(w, x):
        return jnp.sum((x @ w) ** 2)

    w = torch.zeros(512, 512, requires_grad=True)
    x = torch.zeros(256, 512, requires_grad=True)
    _, fwd = analyze(loss, w, x)
    _, g = analyze(lambda w, x: torch.autograd.grad(loss(w, x), [w]), w, x)
    _, g2 = analyze(lambda w, x: torch.autograd.grad(loss(w, x), [w, x]),
                    w, x)
    assert fwd["flops"] == 2.0 * 256 * 512 * 512
    assert g["flops"] == 2 * fwd["flops"]
    assert g2["flops"] == 3 * fwd["flops"]
    jw, jx = jnp.zeros((512, 512)), jnp.zeros((256, 512))
    ref = _hlo(jax.grad(jloss, argnums=(0, 1)), jw, jx)
    assert abs(g2["flops"] - ref["flops"]) <= 0.05 * ref["flops"]


def test_collective_bytes_by_the_ring_model(meshes):
    """A [64, 32] f32 split over "data" (2) gathered whole: one all-gather
    of its 8192 output bytes x 1/2; a partial sum over "model" (4)
    reduced: one all-reduce of 2 x its bytes x 3/4."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = meshes["2x4"]
    x = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    _, got = analyze(lambda t: t.redistribute(mesh, [Replicate()] * 2), x)
    assert got["collective_bytes_by_kind"] == {"all-gather": 8192 * 0.5}
    assert got["collective_count_by_kind"] == {"all-gather": 1}
    p = DTensor.from_local(torch.empty(16, 16, device="meta"), mesh,
                           [Replicate(), Partial()], run_check=False)
    _, got = analyze(lambda t: t.redistribute(mesh, [Replicate()] * 2), p)
    assert got["collective_bytes_by_kind"] == {"all-reduce": 2 * 1024 * 0.75}
    assert got["collective_total_bytes"] == 1536


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_kernel_entry_on_meta_counts_its_work_alone(causal, window):
    """A kernel entry is one row: the FLOPs of the model's algorithm that
    the reference runs in its place (``model_work``: the causal split at
    chunk 16 computes the queries [48, 96) against 96 keys, [24, 48)
    padded to 32 rows against 48 and [0, 24) padded to 32 against 24, so
    6912 (query, key) pairs where the kernel needs the triangle's 4656;
    a window or no mask: all 96 x 96) and the bytes of the kernel's
    ``work``; nothing inside the launch is counted."""
    q = torch.empty(2, 96, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 96, 2, 64, dtype=torch.bfloat16, device="meta")
    _, got = analyze(lambda q, k: flash_ops.flash_gqa(
        q, k, k, causal=causal, window=window, impl="block_tri", chunk=16),
        q, k)
    flops, nbytes = flash_ops.model_work(
        q.shape, k.shape, k.shape, causal=causal, window=window,
        impl="block_tri", chunk=16, elem_bytes=2)
    assert nbytes == flash_ops.work(q.shape, k.shape, k.shape,
                                    causal=causal, window=window,
                                    elem_bytes=2)[1]
    pairs = 48 * 96 + 32 * 48 + 32 * 24 if causal and not window \
        else 96 * 96
    assert flops == 2 * (64 + 64) * pairs * 2 * 8
    assert (got["flops"], got["memory_bytes"]) == (flops, nbytes)
    assert got["kernel_calls"] == {"flash_gqa": 1}
    # the output it allocates (2 x 96 x 8 x 64 bf16) is live at the end
    assert got["peak_bytes"] == got["argument_bytes"] + 196608

    x = torch.empty(2, 64, 4, 16, device="meta")
    dt = torch.empty(2, 64, 4, device="meta")
    A = torch.empty(4, device="meta")
    bc = torch.empty(2, 64, 1, 8, device="meta")
    _, got = analyze(lambda *t: ssd_ops.ssd(*t, chunk=16), x, dt, A, bc, bc)
    assert (got["flops"], got["memory_bytes"]) == ssd_ops.model_work(
        x.shape, bc.shape, chunk=16, elem_bytes=4)
    assert got["kernel_calls"] == {"ssd_scan": 1}

    rows = torch.empty(100, 8, dtype=torch.bfloat16, device="meta")
    ids = torch.empty(100, dtype=torch.int32, device="meta")
    _, got = analyze(lambda r, i: pp_ops.partition_pack(
        r, i, n_parts=6, capacity=24), rows, ids)
    assert (got["flops"], got["memory_bytes"]) == pp_ops.work(100, 16, 6, 24)
    assert got["kernel_calls"] == {"partition_pack": 1}


def _flash_bound_loop(B, Sq, Skv, H, Hkv, D, causal, window, elem_bytes,
                      Dv=None):
    """chip_smoke.py's flash_bound as it stood before ``work``: a loop
    over the queries."""
    Dv = Dv or D
    pairs = 0
    for i in range(Sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        pairs += (i + 1 if causal else Skv) - lo
    return (2 * (D + Dv) * pairs * B * H,
            (B * Sq * H * (D + Dv) + B * Skv * Hkv * (D + Dv)) * elem_bytes
            + 4 * H)


@pytest.mark.parametrize("shape", [
    (4, 512, 512, 32, 2, 128, True, 0, 2, None),      # glm4-9b main
    (4, 512, 512, 16, 16, 192, True, 0, 2, 128),      # MLA prefill
    (1, 4096, 4096, 16, 1, 256, True, 2048, 2, None),  # window binds
    (4, 64, 1500, 6, 6, 64, False, 0, 2, None),       # cross attention
    (1, 384, 384, 2, 1, 64, True, 128, 4, None),      # a Pallas test case
    (2, 65, 65, 4, 4, 192, True, 24, 4, 128),
    (3, 10, 40, 2, 2, 16, False, 7, 4, None)])
def test_flash_work_is_the_loop_bound(shape):
    B, Sq, Skv, H, Hkv, D, causal, window, eb, Dv = shape
    got = flash_ops.work((B, Sq, H, D), (B, Skv, Hkv, D),
                         (B, Skv, Hkv, Dv or D), causal=causal,
                         window=window, elem_bytes=eb)
    assert got == _flash_bound_loop(B, Sq, Skv, H, Hkv, D, causal, window,
                                    eb, Dv)


def test_ssd_and_pack_work_are_the_printed_bounds():
    """The serve phase's prefill shape (SSD_MAIN) in bf16 and the pack's
    main shape: ``work`` gives the formulas chip_smoke.py printed its
    bounds by before it called ``work``."""
    B, S, H, P, G, N, chunk = 4, 512, 80, 64, 1, 128, 128
    Q = chunk
    tri = Q * (Q + 1) // 2
    flops = B * (S // Q) * (G * 2 * tri * N
                            + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * 2 + 4 * B * S * H + 4 * H
              + 2 * B * S * G * N * 2 + 4 * B * H * P * N)
    assert ssd_ops.work((B, S, H, P), (B, S, G, N), chunk=chunk,
                        elem_bytes=2) == (flops, nbytes)
    T, row, n, cap = 1 << 20, 12, 8, 140000
    assert pp_ops.work(T, row, n, cap) == (
        0, 4 * T + T * row + 4 * T + 4 * n + n * cap * row)


def test_peak_counts_live_storages_rounded_to_blocks():
    def f(x):
        a = x + 1                    # 4000 bytes -> 4096
        b = a * 2                    # 4096
        del a
        c = torch.empty(10)          # 40 bytes -> one block
        return b, c

    x = torch.zeros(1000)
    _, got = analyze(f, x)
    assert got["argument_bytes"] == 4096
    assert got["peak_bytes"] == 3 * 4096
    assert BLOCK == 512
