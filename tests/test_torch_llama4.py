"""The llama4 serving slice of the PyTorch port against the JAX package:
the super-block's sub-layer kinds, the parameter, cache and batch
definitions, the MoE block at llama4's smoke config (4 experts, top 1, 1
shared expert, ``moe_impl="a2a"``), one attention layer at the published
width (48 padded q heads over 8 kv heads of 128, chunked-local with rope
and global NoPE), and the whole ``_llama4`` model's prefill, decode and
greedy serving loop at its smoke config (4 layers: one super-block of
chunked + dense, chunked + MoE, chunked + dense, global NoPE + MoE;
d_model 64, 4 q heads padded to 48 over 2 kv heads of 16, chunks of 8).

Weights come from the reference's ``init_params`` through
``repro_torch.models.bridge`` (constant leaves perturbed); tokens and
activations are numpy from a seed. On the CPU attention runs the
reference's own algorithm and the MoE dispatch ``partition_pack``'s plain
version; the card's kernels are held to them in tests/test_torch_cuda.py.
Tolerances: f32 1e-4 (sums in another order); bf16 5 % relative L2
(``_torch_parity.BF16_TOL``); expert choices and dispatch slots exactly;
the decode replay against the prefill 2e-3, as
tests/test_serve_consistency.py holds the reference."""
import ast
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa
from repro.models import model as JMOD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.partition_pack import partition_pack as PK  # noqa
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, param_count)

from _torch_parity import (both, close, match, perturb,  # noqa: E402
                           spec_rows_port, spec_rows_ref)

ARCH = "llama4-maverick-400b-a17b"
B_SERVE, S_SERVE = 2, 16


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(bf16=False, capacity_factor=None):
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    if bf16:
        jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


# ---------------------------------------------------------------- kinds
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_subkinds_match_reference(smoke):
    """One super-block: chunked-local on sub-layers 0-2 and global on 3;
    MoE on sub-layers 1 and 3 (every second), dense MLPs on 0 and 2."""
    jcfg = (jax_smoke_config if smoke else jax_get_config)(ARCH)
    tcfg = (smoke_config if smoke else get_config)(ARCH)
    got = TMOD._llama4_subkinds(tcfg)
    assert got == JMOD._llama4_subkinds(jcfg)
    assert got == [("chunked", "mlp"), ("chunked", "moe"),
                   ("chunked", "mlp"), ("full", "moe")]
    assert TMOD.LLAMA4_PERIOD == JMOD.LLAMA4_PERIOD == 4


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_cache_and_batch_defs_match_reference(smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(
        ARCH))
    tb = build_model((smoke_config if smoke else get_config)(ARCH))
    assert spec_rows_port(tb.param_defs) == spec_rows_ref(jb.param_defs)
    assert spec_rows_port(tb.cache_defs(4, 544)) == \
        spec_rows_ref(jb.cache_defs(4, 544))
    for kind in ("prefill", "decode"):
        assert spec_rows_port(tb.batch_defs(ShapeConfig("serve", 512, 4,
                                                        kind))) == \
            spec_rows_ref(jb.batch_defs(JaxShape("serve", 512, 4, kind)))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    if not smoke:
        assert tb.param_defs["blocks"]["sub1"]["mlp"]["w_gate"].shape == \
            (12, 128, 5120, 8192)
        assert tb.param_defs["blocks"]["sub1"]["mlp"]["w_gate"].dtype == \
            torch.bfloat16


def test_serve_cell_cut_to_one_super_block():
    """The serve cell keeps the published width and cuts the depth to one
    super-block: 4 of 48 layers, 35.3 B parameters, 70.7 GB in bf16."""
    cell = serve.CELLS[ARCH]
    cfg = cell.config()
    assert cell.layers == 4 and cfg.num_layers == 4
    assert cfg.d_model == 5120 and cfg.moe.num_experts == 128
    defs = build_model(cfg).param_defs
    n = param_count(defs)
    assert 35.2e9 < n < 35.4e9
    from repro_torch.models.modules import param_bytes
    assert 70.5e9 < param_bytes(defs) < 70.9e9


# -------------------------------------------------------------- the MoE
@pytest.mark.parametrize("S", [16, 1], ids=["prefill", "decode"])
def test_moe_experts_slots_and_block_match_reference(S):
    """llama4's MoE block (top 1 of 4, 1 shared expert, the reference's
    ``a2a`` path): the experts picked exactly, each entry's dispatch slot
    (drops included) exactly against the reference's per-group
    ``dispatch_indices``, and the block's output and aux loss in f32."""
    jcfg, tcfg = _cfgs()
    assert jcfg.moe_impl == "a2a" and jcfg.moe.num_shared == 1
    pj, pt = both(perturb(jax_init_params(JM.moe_defs(jcfg),
                                          jax.random.key(3)), 3))
    x = _np(3, S, jcfg.d_model, seed=4)
    from repro_torch.models.modules import apply_norm
    h = apply_norm(tcfg.norm_kind, pt["ln"], torch.from_numpy(x),
                   tcfg.norm_eps)
    _, ej, _ = JM.route(jcfg, pj, jnp.asarray(h.numpy()))
    _, et, _ = TM.route(tcfg, pt, h)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    m = tcfg.moe
    C = TM.expert_capacity(S, m.num_experts, m.top_k, m.capacity_factor)
    _, _, slots = TM.dispatch(h, et, m.num_experts, C)
    e = et.numpy().reshape(3, S * m.top_k)
    slots = slots.view(3, -1).numpy()
    for b in range(3):
        sort_idx, dest, keep, _ = map(np.asarray, JM.dispatch_indices(
            jnp.asarray(e[b]), m.num_experts, C))
        got = np.where(slots[b] < C, e[b] * C + slots[b], m.num_experts * C)
        np.testing.assert_array_equal(got[sort_idx], dest)
        np.testing.assert_array_equal(slots[b][sort_idx] < C, keep)
    yj, aj = JM.moe_apply(jcfg, pj, jnp.asarray(x), JaxSharder())
    yt, at = TM.moe_apply(tcfg, pt, torch.from_numpy(x), Sharder())
    close(yt, yj)
    close(at, aj)


# ------------------------------------------------- attention, full width
@pytest.mark.parametrize("kind", ["chunked", "full"],
                         ids=["chunked-rope", "global-nope"])
def test_attention_layer_at_full_width_matches_reference(kind):
    """One llama4 attention layer at its published width (d_model 5120,
    40 q heads padded to 48 over 8 kv heads of 128) in f32, as the
    super-block calls it: chunked-local with rope (chunks of 16 here, so
    that 32 tokens make two chunks), and global with no rope (iRoPE)."""
    jcfg = jax_get_config(ARCH).replace(compute_dtype=jnp.float32,
                                        param_dtype=jnp.float32,
                                        chunked_local=16)
    tcfg = get_config(ARCH).replace(compute_dtype=torch.float32,
                                    param_dtype=torch.float32,
                                    chunked_local=16)
    if kind == "full":
        jcfg, tcfg = (jcfg.replace(rope_theta=0.0),
                      tcfg.replace(rope_theta=0.0))
    assert TT._heads(tcfg) == (48, 8)
    pj, pt = both(perturb(jax_init_params(JT.attn_defs(jcfg),
                                          jax.random.key(8)), 8))
    x = _np(1, 32, jcfg.d_model, seed=9)
    pos = np.arange(32, dtype=np.int32)[None]
    yj, kvj = JT.attn_apply(jcfg, pj, jnp.asarray(x), JaxSharder(),
                            positions=jnp.asarray(pos), layer_kind=kind)
    yt, kvt = TT.attn_apply(tcfg, pt, torch.from_numpy(x), Sharder(),
                            positions=torch.from_numpy(pos), layer_kind=kind)
    close(yt, yj)
    close(kvt["k"], kvj["k"])
    close(kvt["v"], kvj["v"])


# ------------------------------------------------------- the whole model
def _models(seed=5, bf16=False, capacity_factor=None, S=S_SERVE):
    jcfg, tcfg = _cfgs(bf16=bf16, capacity_factor=capacity_factor)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B_SERVE, S)).astype(np.int32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [8, 16, 32], ids=["one-chunk", "S16", "S32"])
def test_prefill_logits_match_reference(S, bf16):
    """At the chunk (8 tokens: one causal call) and above it (16 and 32:
    one call over B x S/8 chunks), at the config's capacity factor."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16, S=S)
    lj, _ = jax.jit(jax_prefill(jb))(pj, {"tokens": jnp.asarray(tokens)})
    before = PK.launches, FK.launches
    lt, ct = make_prefill_step(tb)(pt, {"tokens": torch.from_numpy(tokens)})
    assert (PK.launches, FK.launches) == before   # the CPU takes no kernel
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == S
    assert bool(torch.isfinite(lt.float()).all())
    match(lt, lj, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_decode_logits_match_reference_every_step(bf16):
    """16 steps, past two chunks' rings of 8. In bf16 the reference runs
    op by op (``jax.disable_jit``), rounding after every op as eager
    PyTorch does: the smoke router (4 experts, weights at 0.02) sits near
    ties, which XLA's fused rounding would flip."""
    jcfg, tcfg, jb, tb, pj, pt, tokens = _models(bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    dec_j = jax_decode(jb) if bf16 else jax.jit(jax_decode(jb))
    dec_t = make_decode_step(tb)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        with jax.disable_jit(bf16):
            lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok)})
        lt, ct2 = dec_t(pt, ct, {"token": torch.from_numpy(tok)})
        assert ct2["blocks"] is ct["blocks"]          # written in place
        ct = ct2
        match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    for sub in ("sub0", "sub3"):
        assert ct["blocks"][sub]["k"].dtype == tcfg.compute_dtype
        match(ct["blocks"][sub]["k"], cj["blocks"][sub]["k"], bf16)


def test_decode_replay_matches_prefill():
    """tests/test_serve_consistency.py's property on the port: with
    capacity_factor 100 (decode never drops, so neither may the prefill),
    replaying a prompt of 16 tokens (two chunks) through decode gives the
    prefill's last-position logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens = _models(seed=6, capacity_factor=100.0)
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu")
    close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI for llama4 --smoke (weights from key 0,
    prompts from numpy seed 0) against the port's ``generate`` on the same
    weights and prompts: the same greedy tokens."""
    batch, plen, new = 2, 16, 8
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke"])
    jax_serve.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{ARCH}:")
    want = [ast.literal_eval(line.split(":", 1)[1]) for line in lines
            if line.strip().startswith("seq")]
    assert len(want) == batch and all(len(w) == new for w in want)
    jcfg = jax_smoke_config(ARCH)
    pj = jax_init_params(jax_build_model(jcfg).param_defs, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (batch, plen)).astype(np.int32)
    out = serve.generate(smoke_config(ARCH), tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), torch.from_numpy(tokens), new,
        "cpu")
    assert out.tokens.tolist() == want
    assert out.decode_steps == plen + new - 1


def test_serve_cli_serves_llama4_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", "16", "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2

