"""The MoE combine's kernel entry (``repro_torch.kernels.moe_combine``) on
the CPU: the plain version (``ref.combine``, the combine the model ran
before the kernel) against the batch-major unpack of the same values, bit
for bit, at k of 1 (llama4), 6 (deepseek-v2-lite) and 10 (granite-4.0-h),
with capacity drops, entries of experts not held here (slot C, id 0), a
token whose entries all dropped and a non-finite value in a row only
dropped entries read; the kernel's order of sums (``ref.
combine_in_order``) within rounding of it (``ref.term_step``); the
routes (CPU: the plain version; meta: a shape-only launch); the bytes
``work`` gives; the step analysis's row; and the autograd Function, whose
backward is the plain version's. The card tests hold the kernel itself to
``combine_in_order`` bit for bit (tests/test_torch_cuda.py)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.moe_combine import moe_combine as K  # noqa: E402
from repro_torch.kernels.moe_combine import ops, ref  # noqa: E402
from repro_torch.kernels.partition_pack import ops as pp_ops  # noqa: E402
from repro_torch.launch.step_analysis import analyze  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

B, S, D = 3, 16, 16
# k, experts routed, experts held here (the rest: slot C, id 0), capacity
# factor (below 1: capacity drops)
CASES = {"k1": (1, 4, 4, 0.5), "k6": (6, 16, 16, 0.5),
         "k10": (10, 24, 12, 0.5)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _entries(k, E, held, capacity_factor, seed=0):
    """-> (ids, slots, C) of a dispatch of B x S tokens, each to k
    distinct experts (one of them hot), only the first ``held`` packed."""
    gen = torch.Generator().manual_seed(seed)
    experts = torch.rand(B * S, E, generator=gen)
    experts[:, E - 1] += 0.5 * (torch.rand(B * S, generator=gen) < 0.5)
    experts = torch.topk(experts, k).indices.to(torch.int32)
    C = TM.expert_capacity(S, E, k, capacity_factor)
    _, ids, slots = TM.dispatch(torch.zeros(B, S, 1), experts, E, C,
                                first=0, n_held=held)
    return ids, slots, C


def _inputs(case, dtype, seed=0):
    """A combine's inputs with the edge cases planted: token 0's entries
    all dropped, and NaN and Inf in the row of a kept entry at a
    partition's last slot, which is then dropped (only dropped entries
    read that row)."""
    k, E, held, cf = CASES[case]
    ids, slots, C = _entries(k, E, held, cf, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    eout = torch.randn(held, B * C, D, generator=gen).to(dtype)
    w = torch.rand(B * S, k, generator=gen).to(dtype)
    slots = slots.clone()
    slots[:k] = C
    last = int(torch.nonzero(slots == C - 1)[0])
    slots[last] = C
    flat = eout.view(-1, D)
    flat[int(ids[last]) * C + C - 1] = float("nan")
    flat[int(ids[last]) * C + C - 1, 0] = float("inf")
    return eout, ids, slots, w, C, k


def _unpacked(eout, ids, slots, w, C, k):
    """The combine as the batch-major unpack computes it: eout [E, B*C, d]
    relaid [B*E, C, d], each entry unpacked at (b·E + e, slot) by
    ``partition_unpack`` (zero where dropped), weighted, a token's k
    entries summed."""
    E, BC, d = eout.shape
    nb = BC // C
    e, b = ids // nb, ids % nb
    back = pp_ops.partition_unpack(
        eout.view(E, nb, C, d).transpose(0, 1).reshape(nb * E, C, d),
        b * E + e, slots, C)
    return (back * w.reshape(-1, 1)).view(nb, S, k, d).sum(dim=2)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_plain_combine_is_the_unpack_bit_for_bit(case, dtype):
    eout, ids, slots, w, C, k = _inputs(case, dtype)
    assert bool((slots >= C).any()) and bool((slots < C).any())
    got = ref.combine(eout, ids, slots, w, C, S, k)
    assert got.shape == (B, S, D) and got.dtype == dtype
    assert torch.equal(got, _unpacked(eout, ids, slots, w, C, k))
    assert torch.isfinite(got).all()
    assert torch.equal(got[0, 0], torch.zeros(D, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("case", CASES)
def test_in_order_sum_is_the_plain_sum_within_rounding(case, dtype):
    """The kernel's order (products rounded to the dtype, summed in f32
    one term at a time, rounded once) against the plain version's sum:
    within one step of the last place at the terms' scale in bf16
    (``term_step``), k - 1 such steps in f32; zero where every entry
    dropped."""
    eout, ids, slots, w, C, k = _inputs(case, dtype)
    got = ref.combine_in_order(eout, ids, slots, w, C, S, k)
    want = ref.combine(eout, ids, slots, w, C, S, k)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0, 0], torch.zeros(D, dtype=dtype))
    steps = 1 if dtype == torch.bfloat16 else k - 1
    step = ref.term_step(eout.nan_to_num(0.0, 0.0, 0.0), ids, slots, w, C,
                         S, k)
    assert bool(((got.float() - want.float()).abs() <= steps * step).all())


def test_term_step_is_a_last_place_step_of_the_terms_sum():
    """bf16 keeps 8 significant bits: terms summing to 3 in magnitude
    (whatever their signs) round at steps of 2^-6; f32 at 2^-22."""
    eout = torch.tensor([[[1.0], [-2.0], [0.5]]])
    ids = torch.zeros(3, dtype=torch.int32)
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.0, 0.0]])
    for dtype, want in ((torch.bfloat16, 2 ** -6), (torch.float32,
                                                    2 ** -22)):
        got = ref.term_step(eout.to(dtype), ids, slots, w.to(dtype), 3, 1,
                            3)
        assert got.tolist() == [[[want]]]
    slots = torch.full((3,), 3, dtype=torch.int32)
    assert ref.term_step(eout, ids, slots, w, 3, 1, 3).tolist() == [[[0.0]]]


def test_the_model_combines_through_the_entry():
    assert TM.combine is ops.moe_combine


@pytest.mark.parametrize("case", CASES)
def test_the_cpu_takes_the_plain_version(case):
    eout, ids, slots, w, C, k = _inputs(case, torch.bfloat16)
    before = K.launches
    got = ops.moe_combine(eout, ids, slots, w, C, S, k)
    assert K.launches == before
    assert torch.equal(got, ref.combine(eout, ids, slots, w, C, S, k))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_meta_takes_a_shape_only_launch(dtype):
    k, C, E = 6, 40, 8
    eout = torch.empty(E, B * C, D, dtype=dtype, device="meta")
    ids = torch.empty(B * S * k, dtype=torch.int32, device="meta")
    w = torch.empty(B * S, k, dtype=dtype, device="meta")
    before = K.launches
    got = ops.moe_combine(eout, ids, ids, w, C, S, k)
    assert K.launches == before
    assert got.device.type == "meta" and got.dtype == dtype
    assert got.shape == (B, S, D)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never runs the plain version itself."""
    eout, ids, slots, w, C, k = _inputs("k6", torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        K.combine(eout, ids, slots, w, C, S, k)


def test_work_is_the_closed_form_at_the_cells_shapes():
    """Bytes: the kept rows read once, the output written once, each
    entry's id, slot and weight read once; no counted FLOPs. deepseek-
    v2-lite: 16,384 tokens, top 6, d 2048, 66,500 entries kept;
    granite-4.0-h-small: 32,768 tokens, top 10, d 4096, 163,000 kept."""
    assert ops.work(16_384, 6, 2048, 66_500, 2) == (
        0, 66_500 * 4096 + 16_384 * 4096 + 16_384 * 6 * 10)
    assert ops.work(16_384, 6, 2048, 66_500, 2) == (0, 340_475_904)
    assert ops.work(32_768, 10, 4096, 163_000, 2) == (
        0, 163_000 * 8192 + 32_768 * 8192 + 32_768 * 10 * 10)
    assert ops.work(32_768, 10, 4096, 163_000, 2) == (0, 1_607_008_256)
    assert ops.work(10, 1, 8, 10, 4) == (0, 2 * 10 * 8 * 4 + 10 * 12)


def test_the_step_analysis_counts_the_entry_as_one_row():
    """On meta tensors a combine is one row with ``work``'s bytes at the
    most entries its shapes can keep, min(B·S·k, E·B·C)."""
    k, C, E = 6, 40, 8
    eout = torch.empty(E, B * C, D, dtype=torch.bfloat16, device="meta")
    ids = torch.empty(B * S * k, dtype=torch.int32, device="meta")
    w = torch.empty(B * S, k, dtype=torch.bfloat16, device="meta")
    _, got = analyze(lambda e, i, x: ops.moe_combine(e, i, i, x, C, S, k),
                     eout, ids, w)
    kept = min(B * S * k, E * B * C)
    assert (got["flops"], got["memory_bytes"]) == ops.work(
        B * S, k, D, kept, 2)
    assert got["kernel_calls"] == {"moe_combine": 1}


@pytest.mark.parametrize("case", CASES)
def test_the_kernel_route_differentiates_the_plain_version(monkeypatch,
                                                           case):
    """With the CUDA routing taken on the CPU (the launch replaced by the
    kernel's order in plain PyTorch), the call runs in the autograd
    Function, and eout's and the weights' gradients are those of autograd
    through the plain version, exactly; ids and slots get none."""
    calls = []

    def launch(*t, C, S, k):
        calls.append(1)
        return ref.combine_in_order(*t, C, S, k)
    eout, ids, slots, w, C, k = _inputs(case, torch.float32)
    monkeypatch.setattr(kernels, "on_card", lambda t: True)
    monkeypatch.setattr(K, "_launch", launch)
    eout = eout.nan_to_num(0.0, 0.0, 0.0)
    cot = torch.randn(B, S, D, generator=torch.Generator().manual_seed(3))

    def grads(fn):
        e = eout.clone().requires_grad_()
        x = w.clone().requires_grad_()
        out = fn(e, ids, slots, x, C, S, k)
        return out, torch.autograd.grad((out * cot).sum(), (e, x))

    out, got = grads(ops.moe_combine)
    assert calls == [1] and "Recompute" in out.grad_fn.name()
    _, want = grads(ref.combine)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        ops.moe_combine(eout, ids, slots, w, C, S, k)
    assert calls == [1, 1]
