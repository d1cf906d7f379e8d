"""The whisper serving slice of the PyTorch port against the JAX package:
cross attention, the parameter, cache and batch definitions, all of
whisper-tiny at its published size (4 encoder and 4 decoder layers,
d_model 384, 6 heads of 64, 1500 frames) in f32 (the encoder, a prefill
and a decode step), and the smoke model's prefill, decode and greedy
serving loop, with frames drawn after the prompts from one numpy
generator, as the reference's serve draws them.

Weights come from the reference's ``init_params`` through
``repro_torch.models.bridge`` (constant leaves perturbed; whisper's
``enc`` and ``dec`` are lists of layers); tokens, frames and activations
are numpy from a seed. On the CPU attention runs the reference's own
algorithm; ``flash_gqa`` with Sq != Skv and no mask is held to it on the
card in tests/test_torch_cuda.py. Tolerances: f32 1e-4 (sums in another
order); bf16 5 % relative L2 (``_torch_parity.BF16_TOL``); the decode
replay against the prefill 2e-3, as tests/test_serve_consistency.py holds
the reference."""
import ast

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
from repro.models import transformer as JT  # noqa: E402
from repro.models.model import WHISPER_MAX_DEC  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import apply_norm as jax_apply_norm  # noqa
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import model as TMOD  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model, cast_params  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    Sharder, init_params, param_count)

from _torch_parity import (both, close, match, perturb,  # noqa: E402
                           spec_rows_port, spec_rows_ref)

ARCH = "whisper-tiny"
B_SERVE, S_SERVE = 2, 16


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(full=False, bf16=False):
    jcfg = (jax_get_config if full else jax_smoke_config)(ARCH)
    tcfg = (get_config if full else smoke_config)(ARCH)
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                     torch.float32)
    return (jcfg.replace(compute_dtype=dt[0]),
            tcfg.replace(compute_dtype=dt[1]))


# ------------------------------------------------------- cross attention
@pytest.mark.parametrize("S", [16, 1], ids=["prefill", "decode"])
def test_cross_attention_matches_reference(S):
    """The decoder's S queries against k/v projected from 24 encoder rows,
    no mask and no rope, in f32; the cache passes through untouched."""
    jcfg, tcfg = _cfgs()
    pj, pt = both(perturb(jax_init_params(JT.attn_defs(jcfg),
                                          jax.random.key(2)), 2))
    x = _np(2, S, jcfg.d_model, seed=3)
    enc = _np(2, 24, jcfg.d_model, seed=4)
    pos = np.zeros((2, S), np.int32)
    yj, _ = JT.attn_apply(jcfg, pj, jnp.asarray(x), JaxSharder(),
                          positions=jnp.asarray(pos), layer_kind="cross",
                          kv_override=jnp.asarray(enc))
    marker = {"untouched": True}
    yt, c = TT.attn_apply(tcfg, pt, torch.from_numpy(x), Sharder(),
                          positions=torch.from_numpy(pos),
                          layer_kind="cross", cache=marker,
                          kv_override=torch.from_numpy(enc))
    assert c is marker
    close(yt, yj)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_cache_and_batch_defs_match_reference(smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(
        ARCH))
    tb = build_model((smoke_config if smoke else get_config)(ARCH))
    assert spec_rows_port(tb.param_defs) == spec_rows_ref(jb.param_defs)
    assert spec_rows_port(tb.cache_defs(4, 96)) == \
        spec_rows_ref(jb.cache_defs(4, 96))
    for kind in ("prefill", "decode"):
        assert spec_rows_port(tb.batch_defs(ShapeConfig("serve", 64, 4,
                                                        kind))) == \
            spec_rows_ref(jb.batch_defs(JaxShape("serve", 64, 4, kind)))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    assert TMOD.WHISPER_MAX_DEC == WHISPER_MAX_DEC


# ---------------------------------------------- whisper-tiny, published
@pytest.fixture(scope="module")
def tiny():
    """whisper-tiny at its published size in f32: both packages' bundles,
    one set of weights, 2 requests of 1500 frames and 8 tokens."""
    jcfg, tcfg = _cfgs(full=True)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          3))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    frames = rng.normal(size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(
        np.float32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens, frames


def test_published_size_encoder_matches_reference(tiny):
    """The encoder's output over 1500 frames (a length no multiple of the
    kernel's 64-row tiles), every layer bidirectional. The reference's
    ``encode`` is a closure of its bundle, so its lines run here as
    ``_whisper.encode`` runs them."""
    jcfg, tcfg, jb, tb, pj, pt, tokens, frames = tiny
    assert tcfg.encoder_seq == 1500 and TT._heads(tcfg) == (6, 6)
    x = jnp.asarray(frames) + pj["enc_pos"][None]
    pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
    for lp in pj["enc"]:
        x, _ = JT.attn_apply(jcfg, lp["attn"], x, JaxSharder(), positions=pos,
                             layer_kind="bidir")
        x = JT.mlp_apply(jcfg, lp["mlp"], x, JaxSharder())
    want = jax_apply_norm(jcfg.norm_kind, pj["enc_ln"], x, jcfg.norm_eps)
    close(tb.encode(pt, torch.from_numpy(frames)), want)


def test_published_size_prefill_and_decode_step_match_reference(tiny):
    """The prefill's last logits over 8 tokens after 1500 frames, then one
    decode step at position 5 (which encodes the frames again) against a
    cache of random k/v handed to both, all in f32 at 1e-4."""
    jcfg, tcfg, jb, tb, pj, pt, tokens, frames = tiny
    lj, _ = jax.jit(jax_prefill(jb))(pj, {"tokens": jnp.asarray(tokens),
                                          "frames": jnp.asarray(frames)})
    lt, ct = make_prefill_step(tb)(pt, {"tokens": torch.from_numpy(tokens),
                                        "frames": torch.from_numpy(frames)})
    assert tuple(lt.shape) == (2, 1, tcfg.vocab_size)
    assert int(ct["len"]) == 8
    close(lt, lj)
    n = 8
    cj = jax_init_params(jb.cache_defs(2, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(2, n), None, "cpu")
    rng = np.random.default_rng(4)
    kv = [{k: rng.standard_normal(c[k].shape).astype(np.float32)
           for k in ("k", "v")} for c in ct["dec"]]
    cj = {"dec": [{k: jnp.asarray(v) for k, v in c.items()} for c in kv],
          "len": jnp.int32(5)}
    ct = {"dec": [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
                  for c in kv], "len": torch.tensor(5, dtype=torch.int32)}
    tok = tokens[:, 5:6]
    lj, cj = jax.jit(jax_decode(jb))(pj, cj, {
        "token": jnp.asarray(tok), "frames": jnp.asarray(frames)})
    lt, ct2 = make_decode_step(tb)(pt, ct, {
        "token": torch.from_numpy(tok), "frames": torch.from_numpy(frames)})
    assert ct2["dec"] is ct["dec"] and int(ct2["len"]) == 6
    close(lt, lj)
    close(ct["dec"][3]["k"], cj["dec"][3]["k"])


# ------------------------------------------------------- the smoke model
def _models(seed=5, bf16=False):
    jcfg, tcfg = _cfgs(bf16=bf16)
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = both(perturb(jax_init_params(jb.param_defs, jax.random.key(0)),
                          seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size,
                          (B_SERVE, S_SERVE)).astype(np.int32)
    frames = rng.normal(size=(B_SERVE, jcfg.encoder_seq,
                              jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens, frames


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prefill_logits_match_reference(bf16):
    jcfg, tcfg, jb, tb, pj, pt, tokens, frames = _models(bf16=bf16)
    lj, _ = jax.jit(jax_prefill(jb))(pj, {
        "tokens": jnp.asarray(tokens),
        "frames": jnp.asarray(frames, jcfg.compute_dtype)})
    before = FK.launches
    lt, ct = make_prefill_step(tb)(pt, serve.prefill_batch(
        tb, torch.from_numpy(tokens), torch.from_numpy(frames)))
    assert FK.launches == before                  # the CPU takes no kernel
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert int(ct["len"]) == S_SERVE
    assert bool(torch.isfinite(lt.float()).all())
    match(lt, lj, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_decode_logits_match_reference_every_step(bf16):
    jcfg, tcfg, jb, tb, pj, pt, tokens, frames = _models(bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    dec_j, dec_t = jax.jit(jax_decode(jb)), make_decode_step(tb)
    fj = jnp.asarray(frames, jcfg.compute_dtype)
    ft = torch.from_numpy(frames).to(tcfg.compute_dtype)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok), "frames": fj})
        lt, ct = dec_t(pt, ct, {"token": torch.from_numpy(tok),
                                "frames": ft})
        match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    assert ct["dec"][1]["k"].dtype == tcfg.compute_dtype
    match(ct["dec"][1]["v"], cj["dec"][1]["v"], bf16)


def test_decode_replay_matches_prefill():
    """tests/test_serve_consistency.py's property on the port: replaying
    the prompt through decode (re-encoding the frames at every step) gives
    the prefill's last-position logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens, frames = _models(seed=6)
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu",
                         torch.from_numpy(frames))
    close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


def test_random_request_draws_frames_after_the_prompts():
    """The reference's serve draws the prompts, then the frames, from one
    numpy generator; so does ``random_request``."""
    tcfg = smoke_config(ARCH)
    _, tokens, frames = serve.random_request(tcfg, 2, 16, 0, "cpu")
    rng = np.random.default_rng(0)
    want_t = rng.integers(0, tcfg.vocab_size, (2, 16))
    want_f = rng.normal(size=(2, tcfg.encoder_seq, tcfg.d_model))
    np.testing.assert_array_equal(tokens.numpy(), want_t)
    np.testing.assert_array_equal(frames.numpy(), want_f.astype(np.float32))
    assert serve.random_request(smoke_config("glm4-9b"), 2, 16, 0,
                                "cpu")[2] is None


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI for whisper-tiny --smoke (weights from
    key 0, prompts and then frames from numpy seed 0) against the port's
    ``generate`` on the same weights, prompts and frames: the same greedy
    tokens."""
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
    _, tokens, frames = serve.random_request(smoke_config(ARCH), batch, plen,
                                             0, "cpu")
    out = serve.generate(smoke_config(ARCH), tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), tokens, new, "cpu", frames)
    assert out.tokens.tolist() == want


def test_cast_params_keeps_the_layer_lists():
    """``cast_params`` walks whisper's ``enc`` and ``dec`` lists: their
    weights take the compute dtype, the LayerNorms stay f32, and the bf16
    logits are those of the uncast tree."""
    _, tcfg, _, tb, _, pt, tokens, frames = _models(seed=7, bf16=True)
    cp = cast_params(tcfg, pt)
    assert isinstance(cp["enc"], list) and len(cp["dec"]) == 2
    assert cp["dec"][0]["cross"]["wq"].dtype == torch.bfloat16
    assert cp["enc"][1]["attn"]["ln"]["scale"].dtype == torch.float32
    assert pt["dec"][0]["cross"]["wq"].dtype == torch.float32
    step = make_prefill_step(tb)
    batch = serve.prefill_batch(tb, torch.from_numpy(tokens),
                                torch.from_numpy(frames))
    assert torch.equal(step(pt, batch)[0], step(cp, batch)[0])


def test_serve_cli_serves_whisper_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"{ARCH}: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2
    assert serve.CELLS[ARCH] == serve.ServeCell(ARCH, prompt=64)
