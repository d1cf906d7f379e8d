"""The MoE block of the PyTorch port (``repro_torch.models.moe``) against
the JAX package's (``repro.models.moe``): the router, the dispatch
bookkeeping, the pack that the port dispatches through, and the whole
block with and without capacity drops, at deepseek-v2-lite-16b's smoke
config (4 experts, top 2, 1 shared expert).

Weights come from the reference's ``init_params`` through
``repro_torch.models.bridge`` (constant leaves perturbed); activations
are numpy from a seed. On the CPU the port's dispatch runs
``partition_pack``'s plain version; the CUDA kernel is held to the same
slots in tests/test_torch_cuda.py. Tolerances: expert choices and slots
exactly; router weights and the aux loss 1e-6 (one softmax in f32);
the block 1e-4 in f32 (sums in another order), 5 % relative L2 in
bf16."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.models import moe as JM  # noqa: E402
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as PK  # noqa
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.modules import Sharder  # noqa: E402

from _torch_parity import (both, close, match, perturb,  # noqa: E402
                           spec_rows_port, spec_rows_ref)

ARCH = "deepseek-v2-lite-16b"
ROUTE_TOL = 1e-6


def _cfgs(capacity_factor=None, bf16=False):
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    if bf16:
        jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    return jcfg, tcfg


def _params(jcfg, seed):
    return both(perturb(jax_init_params(JM.moe_defs(jcfg),
                                        jax.random.key(seed)), seed))


def _x(B, S, d, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            * scale).astype(np.float32)


def test_moe_defs_match_reference():
    jcfg, tcfg = _cfgs()
    assert spec_rows_port(TM.moe_defs(tcfg)) == \
        spec_rows_ref(JM.moe_defs(jcfg))


@pytest.mark.parametrize("args", [(512, 64, 6, 1.5), (1, 64, 6, 1.5),
                                  (8, 4, 2, 0.25), (16, 4, 2, 100.0),
                                  (3, 4, 1, 1.25)])
def test_expert_capacity_matches_reference(args):
    assert TM.expert_capacity(*args) == JM.expert_capacity(*args)


@pytest.mark.parametrize("B,S", [(2, 16), (4, 1)], ids=["prefill", "decode"])
def test_route_matches_reference(B, S):
    """Experts exactly; the renormalized weights and the Switch aux loss
    within 1e-6 (f32 softmax on both sides)."""
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg, 1)
    h = _x(B, S, jcfg.d_model, 2, scale=1.0)
    wj, ej, aj = JM.route(jcfg, pj, jnp.asarray(h))
    wt, et, at = TM.route(tcfg, pt, torch.from_numpy(h))
    assert et.dtype == torch.int32 and wt.dtype == torch.float32
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    close(wt, wj, ROUTE_TOL)
    close(at, aj, ROUTE_TOL)


DISPATCH = {            # entries, experts, capacity, seed
    "no-drops": (32, 4, 16, 0),
    "drops": (32, 4, 4, 1),
    "capacity-8-of-64": (96, 64, 8, 2),
    "hot-expert": (24, 4, 8, 3),
}


def _experts(n, E, seed, hot=False):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, E, n).astype(np.int32)
    if hot:
        e[rng.random(n) < 0.7] = E - 1
    return e


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_indices_match_reference(case):
    n, E, C, seed = DISPATCH[case]
    e = _experts(n, E, seed, hot=case == "hot-expert")
    want = JM.dispatch_indices(jnp.asarray(e), E, C)
    got = TM.dispatch_indices(torch.from_numpy(e), E, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("capacity_factor", [0.25, 1.5, 100.0],
                         ids=["drops", "serve", "no-drops"])
def test_dispatch_slots_equal_dispatch_indices(capacity_factor):
    """The port's one pack over B·E ids puts every entry of every group
    where the reference's per-group ``dispatch_indices`` does, dropped
    entries included, and packs each kept entry's token row there, in the
    expert-major buffer: expert e's row b·C + slot."""
    _, tcfg = _cfgs(capacity_factor)
    m = tcfg.moe
    B, S, d = 3, 16, 8
    C = TM.expert_capacity(S, m.num_experts, m.top_k, capacity_factor)
    e = np.stack([_experts(S * m.top_k, m.num_experts, b, hot=b == 1)
                  for b in range(B)])
    h = torch.from_numpy(_x(B, S, d, 4))
    buf, ids, slots = TM.dispatch(h, torch.from_numpy(e).view(
        B * S, m.top_k), m.num_experts, C)
    assert buf.shape == (m.num_experts, B * C, d)
    slots = slots.view(B, -1)
    dropped = 0
    for b in range(B):
        sort_idx, dest, keep, _ = JM.dispatch_indices(
            jnp.asarray(e[b]), m.num_experts, C)
        sort_idx, dest, keep = map(np.asarray, (sort_idx, dest, keep))
        # the reference's rows in entry order
        got_dest = np.where(slots[b].numpy() < C,
                            e[b] * C + slots[b].numpy(), m.num_experts * C)
        np.testing.assert_array_equal(got_dest[sort_idx], dest)
        np.testing.assert_array_equal(slots[b].numpy()[sort_idx] < C, keep)
        dropped += int((~keep).sum())
        for j in np.flatnonzero(slots[b].numpy() < C):
            assert torch.equal(buf[e[b, j], b * C + slots[b, j]],
                               h[b, j // m.top_k])
    if capacity_factor == 0.25:
        assert dropped > 0
    if capacity_factor == 100.0:
        assert dropped == 0


def _batch_major_combine(eout, ids, slots, weights, C, S, k):
    """The combine as it read a batch-major buffer: eout [E, B*C, d]
    relaid [B*E, C, d], each entry unpacked at (b·E + e, slot) by
    ``ops.partition_unpack`` (zero where dropped), weighted, a token's k
    entries summed."""
    from repro_torch.kernels.partition_pack import ops
    E, BC, d = eout.shape
    B = BC // C
    e, b = ids // B, ids % B
    back = ops.partition_unpack(
        eout.view(E, B, C, d).transpose(0, 1).reshape(B * E, C, d),
        b * E + e, slots, C)
    return (back * weights.reshape(-1, 1)).view(B, S, k, d).sum(dim=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [0.25, 1.5, 100.0],
                         ids=["drops", "serve", "no-drops"])
def test_combine_equals_the_batch_major_unpack(capacity_factor, dtype):
    """The one-device combine, a gather from the expert-major output seen
    flat, gives the bits of the unpack of the same values laid out batch
    major, weighted and summed over k, drops included; and a non-finite
    value in a row that only dropped entries read stays out of the
    output."""
    _, tcfg = _cfgs(capacity_factor)
    m = tcfg.moe
    E, k = m.num_experts, m.top_k
    B, S, d = 3, 16, 8
    C = TM.expert_capacity(S, E, k, capacity_factor)
    e = np.stack([_experts(S * k, E, b, hot=b == 1) for b in range(B)])
    _, ids, slots = TM.dispatch(torch.zeros(B, S, d), torch.from_numpy(
        e).view(B * S, k), E, C)
    gen = torch.Generator().manual_seed(11)
    eout = torch.randn(E, B * C, d, generator=gen).to(dtype)
    w = torch.rand(B * S, k, generator=gen).to(dtype)
    got = TM.combine(eout, ids, slots, w, C, S, k)
    assert got.shape == (B, S, d) and got.dtype == dtype
    assert torch.equal(got, _batch_major_combine(eout, ids, slots, w, C, S,
                                                 k))
    if capacity_factor != 0.25:
        return
    # drop the kept entry in a full partition's last slot: only dropped
    # entries read that row now
    last = int(np.flatnonzero(slots.numpy() == C - 1)[0])
    slots = slots.clone()
    slots[last] = C
    flat = eout.view(-1, d)
    flat[int(ids[last]) * C + C - 1] = float("nan")
    flat[int(ids[last]) * C + C - 1, 0] = float("inf")
    got = TM.combine(eout, ids, slots, w, C, S, k)
    assert torch.isfinite(got).all()
    assert torch.equal(got, _batch_major_combine(eout, ids, slots, w, C, S,
                                                 k))


@pytest.mark.parametrize("capacity_factor", [0.25, 1.5, 100.0],
                         ids=["drops", "serve", "no-drops"])
@pytest.mark.parametrize("S", [16, 1], ids=["prefill", "decode"])
def test_moe_apply_matches_reference(S, capacity_factor):
    """tests/test_moe_correctness.py's block in f32, at the smoke config's
    serve capacity and with and without drops: output and aux loss within
    1e-4; the CPU takes no kernel launch."""
    jcfg, tcfg = _cfgs(capacity_factor)
    pj, pt = _params(jcfg, 5)
    x = _x(2, S, jcfg.d_model, 6)
    yj, aj = JM.moe_apply(jcfg, pj, jnp.asarray(x), JaxSharder())
    before = PK.launches
    yt, at = TM.moe_apply(tcfg, pt, torch.from_numpy(x), Sharder())
    assert PK.launches == before
    close(yt, yj)
    close(at, aj)


def test_moe_apply_bf16_matches_reference():
    jcfg, tcfg = _cfgs(bf16=True)
    pj, pt = _params(jcfg, 7)
    x = _x(2, 16, jcfg.d_model, 8)
    yj, _ = JM.moe_apply(jcfg, pj, jnp.asarray(x, jnp.bfloat16),
                         JaxSharder())
    yt, _ = TM.moe_apply(tcfg, pt, torch.from_numpy(x).bfloat16(),
                         Sharder())
    match(yt - torch.from_numpy(x).bfloat16(),
          np.asarray(yj, np.float32) - np.asarray(
              jnp.asarray(x, jnp.bfloat16), np.float32), bf16=True)


def test_moe_apply_matches_dense_per_token_reference():
    """tests/test_moe_correctness.py's dense per-token oracle (every token
    through its top-k experts directly, in f64) on the port's block, at
    capacity_factor 100 (nothing drops)."""
    jcfg, tcfg = _cfgs(100.0)
    pj, pt = _params(jcfg, 9)
    x = _x(2, 8, jcfg.d_model, 10)
    m = tcfg.moe
    got, _ = TM.moe_apply(tcfg, pt, torch.from_numpy(x), Sharder())
    from repro_torch.models.modules import apply_norm
    h = apply_norm(tcfg.norm_kind, pt["ln"], torch.from_numpy(x),
                   tcfg.norm_eps)
    w, e, _ = TM.route(tcfg, pt, h)
    w, e = w.double().view(2, 8, m.top_k), e.view(2, 8, m.top_k)
    hn = h.double()
    want = torch.from_numpy(x).double().clone()
    for b in range(2):
        for t in range(8):
            for j in range(m.top_k):
                ex = int(e[b, t, j])
                g = hn[b, t] @ pt["w_gate"][ex].double()
                u = hn[b, t] @ pt["w_up"][ex].double()
                want[b, t] += w[b, t, j] * ((torch.nn.functional.silu(g) * u)
                                            @ pt["w_down"][ex].double())
    sp = {k: v.double() for k, v in pt["shared"].items()}
    want += (torch.nn.functional.silu(hn @ sp["w_gate"]) * (hn @ sp["w_up"])
             ) @ sp["w_down"]
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)
