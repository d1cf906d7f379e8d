"""The Mamba-2 serving slice of the PyTorch port against the JAX package:
configs, parameter definitions, one ``mamba_apply`` layer on both paths
(smoke width and full width), and the whole model's prefill, decode and
greedy serving loop at the smoke config.

Weights come from the reference's ``init_params`` and cross over through
``repro_torch.models.bridge``; the leaves the reference initializes to
constants (A_log, dt_bias, D, conv_b, norm scales) are first given random
values so that every parameter moves the output. Tokens and activations are
numpy from a seed. Everything runs on the CPU in float32; the whole
model's prefill and decode run in bf16 as well, as mamba2-2.7b serves.
Where the reference can reach its Pallas kernel it runs it in interpret
mode."""
import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import registry as jax_registry  # noqa: E402
from repro.configs.smoke import smoke_config as jax_smoke_config  # noqa
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch.steps import make_decode_step as jax_decode  # noqa
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa
from repro.models import mamba2 as JM  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa
from repro.models.modules import Sharder as JaxSharder  # noqa: E402
from repro.models.modules import init_params as jax_init_params  # noqa
from repro.models.modules import param_count as jax_param_count  # noqa
from repro.models import modules as JMOD  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as K  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step)
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models.bridge import tree_from_numpy  # noqa: E402
from repro_torch.models.model import build_model, cast_params  # noqa: E402
from repro_torch.models import modules as TMOD  # noqa: E402
from repro_torch.models.modules import (  # noqa: E402
    ParamSpec, Sharder, init_params, param_bytes, param_count)

from _torch_parity import BF16_TOL  # noqa: E402
from _torch_parity import both as _both  # noqa: E402
from _torch_parity import PORT_FIELDS, PORT_MOE_FIELDS  # noqa: E402
from _torch_parity import cfg_dict as _cfg_dict  # noqa: E402
from _torch_parity import port_fields as _port_fields  # noqa: E402
from _torch_parity import close as _close  # noqa: E402
from _torch_parity import match as _match  # noqa: E402
from _torch_parity import perturb as _perturb  # noqa: E402
from _torch_parity import rel_l2 as _rel_l2  # noqa: E402
from _torch_parity import spec_rows_port as _spec_rows_port  # noqa: E402
from _torch_parity import spec_rows_ref as _spec_rows_ref  # noqa: E402

ARCH = "mamba2-2.7b"


def _cfgs(kind: str):
    """(reference cfg, port cfg) with f32 compute."""
    if kind == "smoke":
        return jax_smoke_config(ARCH), smoke_config(ARCH)
    return (jax_get_config(ARCH).replace(compute_dtype=jnp.float32),
            get_config(ARCH).replace(compute_dtype=torch.float32))


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(jax_registry()))
def test_config_matches_reference(arch, smoke):
    """Field for field; the port's own fields, which the reference lacks,
    at the values that leave the arch as the reference has it."""
    want = _cfg_dict((jax_smoke_config if smoke else jax_get_config)(arch))
    got = _cfg_dict((smoke_config if smoke else get_config)(arch))
    own = dict(PORT_FIELDS)
    if got["moe"] is not None:
        own["moe"] = PORT_MOE_FIELDS
    assert _port_fields(got, want) == own
    assert got == want


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_cache_and_batch_defs_match_reference(smoke):
    jb = jax_build_model((jax_smoke_config if smoke else jax_get_config)(ARCH))
    tb = build_model((smoke_config if smoke else get_config)(ARCH))
    assert _spec_rows_port(tb.param_defs) == _spec_rows_ref(jb.param_defs)
    assert _spec_rows_port(tb.cache_defs(4, 544)) == \
        _spec_rows_ref(jb.cache_defs(4, 544))
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("serve", 512, 4, kind)
        assert _spec_rows_port(tb.batch_defs(shape)) == \
            _spec_rows_ref(jb.batch_defs(shape))
    assert param_count(tb.param_defs) == jax_param_count(jb.param_defs)
    if not smoke:
        assert param_count(tb.param_defs) == 2_702_599_680
        assert param_bytes(tb.param_defs) == 4 * 2_702_599_680


def test_sharder_takes_no_mesh_yet():
    """The Sharder leaves a plain tensor as it is, with no mesh and with
    one: only a DTensor on a mesh is redistributed (the dry run's meshes;
    ``tests/test_torch_dryrun_mesh*.py``)."""
    x = torch.ones(2)
    assert Sharder()(x, "batch") is x
    assert Sharder(mesh=object())(x, "batch") is x


def test_init_params_kinds_and_scales():
    """Same kinds and fan-in scales as the reference's _init_one."""
    defs = {"w": ParamSpec((400, 300), ("a", "b")),
            "stack": ParamSpec((3, 500, 20), ("l", "a", "b")),
            "e": ParamSpec((1000, 8), ("v", "e"), init="embed",
                           init_scale=0.02),
            "s": ParamSpec((2000,), ("a",), init="small"),
            "z": ParamSpec((4,), ("a",), init="zeros", dtype=torch.int32),
            "o": ParamSpec((4, 2), ("a", "b"), init="ones",
                           dtype=torch.bfloat16)}
    p = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    for k, scale in (("w", 400 ** -0.5), ("stack", 500 ** -0.5),
                     ("e", 0.02), ("s", 0.02)):
        assert abs(float(p[k].std()) / scale - 1) < 0.05, k
    assert p["z"].dtype == torch.int32 and not p["z"].any()
    assert p["o"].dtype == torch.bfloat16 and bool((p["o"] == 1).all())
    with pytest.raises(ValueError, match="Generator"):
        init_params(defs, None, "cpu")


def test_bridge_keeps_paths_and_dtypes():
    tree = {"a": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)},
            "b": [jnp.array([1.5, -2.25], jnp.bfloat16)],
            "len": jnp.int32(7)}
    got = tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    assert got["a"]["w"].dtype == torch.float32
    assert got["a"]["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert got["b"][0].dtype == torch.bfloat16
    assert got["b"][0].tolist() == [1.5, -2.25]
    assert got["len"].dtype == torch.int32 and int(got["len"]) == 7


# -------------------------------------------------------------- modules
def _modules_case(name, rng):
    """(reference fn, port fn, numpy args) of one NN piece of modules.py."""
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 2
    scale = (1 + 0.3 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(16)).astype(np.float32)
    labels = rng.integers(0, 16, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.7).astype(np.int32)
    return {
        "rms_norm": (JMOD.rms_norm, TMOD.rms_norm, (x, scale)),
        "layer_norm": (JMOD.layer_norm, TMOD.layer_norm, (x, scale, bias)),
        "apply_norm_ln": (
            lambda *a: JMOD.apply_norm("ln", {"scale": a[1], "bias": a[2]},
                                       a[0], 1e-5),
            lambda *a: TMOD.apply_norm("ln", {"scale": a[1], "bias": a[2]},
                                       a[0], 1e-5), (x, scale, bias)),
        "gelu": (JMOD.gelu, TMOD.gelu, (x,)),
        "swiglu": (JMOD.swiglu, TMOD.swiglu, (x, x[::-1].copy())),
        "cross_entropy": (JMOD.softmax_cross_entropy,
                          TMOD.softmax_cross_entropy, (x, labels)),
        "cross_entropy_masked": (JMOD.softmax_cross_entropy,
                                 TMOD.softmax_cross_entropy,
                                 (x, labels, mask)),
    }[name]


@pytest.mark.parametrize("name", [
    "rms_norm", "layer_norm", "apply_norm_ln", "gelu", "swiglu",
    "cross_entropy", "cross_entropy_masked"])
def test_nn_pieces_match_reference(name):
    fj, ft, args = _modules_case(name, np.random.default_rng(len(name)))
    want = fj(*map(jnp.asarray, args))
    got = ft(*map(torch.from_numpy, args))
    _close(got, want, 1e-5)


def test_rms_norm_rounds_before_scaling():
    """bf16 in: normalized, cast back to bf16, then times the scale, in the
    reference's order; the same bf16 numbers."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    want = JMOD.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    got = TMOD.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                        torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------- one Mamba layer
@pytest.mark.parametrize("kind,B,S", [("smoke", 2, 16), ("full", 1, 256)])
def test_mamba_apply_full_sequence_matches_pallas_reference(kind, B, S):
    """The reference with use_pallas (its Pallas kernel, interpret mode);
    the port's CPU path (the plain chunked SSD), which also returns the
    state a decode step continues from."""
    jcfg, tcfg = _cfgs(kind)
    jcfg = jcfg.replace(use_pallas=True)
    pj, pt = _both(_perturb(
        jax_init_params(JM.mamba_defs(jcfg), jax.random.key(0)), 1))
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    yj, _ = JM.mamba_apply(jcfg, pj, jnp.asarray(x), JaxSharder())
    before = K.launches
    yt, cache = TM.mamba_apply(tcfg, pt, torch.from_numpy(x), Sharder())
    d_in, H, conv_dim = TM.dims(tcfg)
    assert K.launches == before
    assert cache["conv"].shape == (B, tcfg.ssm_conv - 1, conv_dim)
    assert cache["ssm"].shape == (B, H, tcfg.ssm_head_dim, tcfg.ssm_state)
    _close(yt, yj)


@pytest.mark.parametrize("kind,B,steps", [("smoke", 2, 4), ("full", 1, 2)])
def test_mamba_apply_decode_matches_reference(kind, B, steps):
    """The single-token recurrence from a random (non-zero) cache."""
    jcfg, tcfg = _cfgs(kind)
    pj, pt = _both(_perturb(
        jax_init_params(JM.mamba_defs(jcfg), jax.random.key(0)), 3))
    rng = np.random.default_rng(4)
    d_in, nheads, conv_dim = JM.dims(jcfg)
    cj, ct = _both({
        "conv": rng.standard_normal(
            (B, jcfg.ssm_conv - 1, conv_dim)).astype(np.float32),
        "ssm": rng.standard_normal(
            (B, nheads, jcfg.ssm_head_dim, jcfg.ssm_state)).astype(
                np.float32)})
    x = rng.standard_normal((B, steps, jcfg.d_model)).astype(np.float32)
    for t in range(steps):
        yj, cj = JM.mamba_apply(jcfg, pj, jnp.asarray(x[:, t:t + 1]),
                                JaxSharder(), cache=cj)
        yt, ct = TM.mamba_apply(tcfg, pt, torch.from_numpy(x[:, t:t + 1]),
                                Sharder(), cache=ct)
        _close(yt, yj)
        _close(ct["conv"], cj["conv"])
        _close(ct["ssm"], cj["ssm"])


# ------------------------------------------------------- the whole model
B_SERVE, S_SERVE = 2, 16


def _smoke_models(seed: int = 5, bf16: bool = False, layers: int = 0):
    """Smoke-config models on one set of bridged weights; ``bf16`` computes
    in bf16 (the weights stay f32), ``layers`` overrides the depth."""
    jcfg, tcfg = _cfgs("smoke")
    if bf16:
        jcfg = jcfg.replace(compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(compute_dtype=torch.bfloat16)
    if layers:
        jcfg, tcfg = (jcfg.replace(num_layers=layers),
                      tcfg.replace(num_layers=layers))
    jb, tb = jax_build_model(jcfg), build_model(tcfg)
    pj, pt = _both(_perturb(
        jax_init_params(jb.param_defs, jax.random.key(0)), seed))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B_SERVE, S_SERVE)).astype(np.int32)
    return jcfg, tcfg, jb, tb, pj, pt, tokens


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["ref-plain", "ref-pallas"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prefill_logits_match_reference(bf16, use_pallas):
    jcfg, tcfg, _, tb, pj, pt, tokens = _smoke_models(bf16=bf16)
    jb = jax_build_model(jcfg.replace(use_pallas=use_pallas))
    lj, cj = jax.jit(jax_prefill(jb))(pj, {"tokens": jnp.asarray(tokens)})
    lt, ct = make_prefill_step(tb)(pt, {"tokens": torch.from_numpy(tokens)})
    assert tuple(lt.shape) == (B_SERVE, 1, tcfg.vocab_size)
    assert ct["len"].dtype == torch.int32 and int(ct["len"]) == S_SERVE
    assert bool(torch.isfinite(lt.float()).all())
    _match(lt, lj, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_decode_logits_match_reference_every_step(bf16):
    jcfg, tcfg, jb, tb, pj, pt, tokens = _smoke_models(bf16=bf16)
    n = S_SERVE + 4
    cj = jax_init_params(jb.cache_defs(B_SERVE, n), jax.random.key(1))
    ct = init_params(tb.cache_defs(B_SERVE, n), None, "cpu")
    dec_j, dec_t = jax.jit(jax_decode(jb)), make_decode_step(tb)
    for t in range(S_SERVE):
        tok = tokens[:, t:t + 1]
        lj, cj = dec_j(pj, cj, {"token": jnp.asarray(tok)})
        lt, ct = dec_t(pt, ct, {"token": torch.from_numpy(tok)})
        _match(lt, lj, bf16)
        assert int(ct["len"]) == int(cj["len"]) == t + 1
    assert ct["layers"]["ssm"].dtype == torch.float32
    if bf16:
        assert _rel_l2(ct["layers"]["ssm"], cj["layers"]["ssm"]) <= BF16_TOL
    else:
        _close(ct["layers"]["ssm"], cj["layers"]["ssm"])
        _close(ct["layers"]["conv"], cj["layers"]["conv"])


def test_greedy_tokens_match_reference_serve(monkeypatch, capsys):
    """The reference's serve.py CLI (weights from key 0, prompts from
    numpy seed 0) against the port's ``generate`` on the same weights and
    prompts: the same greedy tokens."""
    batch, plen, new = 2, 16, 8
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--smoke", "--prompt-len", str(plen),
        "--new-tokens", str(new), "--batch", str(batch)])
    jax_serve.main()
    lines = capsys.readouterr().out.splitlines()
    want = [ast.literal_eval(line.split(":", 1)[1]) for line in lines
            if line.strip().startswith("seq")]
    assert len(want) == batch and all(len(w) == new for w in want)
    jcfg, tcfg = _cfgs("smoke")
    pj = jax_init_params(jax_build_model(jcfg).param_defs, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (batch, plen)).astype(np.int32)
    out = serve.generate(tcfg, tree_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"), torch.from_numpy(tokens), new,
        "cpu")
    assert out.tokens.dtype == torch.int32
    assert out.tokens.tolist() == want
    assert out.decode_steps == plen + new - 1


def test_decode_replay_matches_prefill():
    """The reference's serve-consistency property on the port
    (tests/test_serve_consistency.py): replaying the prompt through decode
    gives the prefill's last-position logits, at its 2e-3."""
    _, tcfg, _, _, _, pt, tokens = _smoke_models(seed=6)
    out = serve.generate(tcfg, pt, torch.from_numpy(tokens), 3, "cpu")
    _close(out.replay_logits, out.prefill_logits.numpy(), 2e-3)
    assert tuple(out.tokens.shape) == (B_SERVE, 3)


def test_cast_params_changes_no_number():
    """Casting the weights to the compute dtype once equals the model's
    cast at every use: bf16 compute, exactly equal logits."""
    tcfg = smoke_config(ARCH).replace(compute_dtype=torch.bfloat16)
    tb = build_model(tcfg)
    p = init_params(tb.param_defs, torch.Generator().manual_seed(7), "cpu")
    cp = cast_params(tcfg, p)
    assert cp["layers"]["in_proj"].dtype == torch.bfloat16
    assert cp["layers"]["A_log"].dtype == torch.float32
    assert cp["layers"]["dt_bias"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    step = make_prefill_step(tb)
    assert torch.equal(step(p, {"tokens": tokens})[0],
                       step(cp, {"tokens": tokens})[0])


# ------------------------------------------------------------------- bf16
@pytest.mark.parametrize("layers", [4, 16, 64])
def test_bf16_drift_with_depth_matches_reference(layers):
    """Through random layers bf16 rounding compounds: the reference's own
    bf16 prefill logits move away from its f32 ones as depth grows (to
    about 0.6 relative L2 at mamba2-2.7b's 64 layers, smoke width). The
    port's bf16 logits lie no further from the f32 answer, nor from the
    reference's bf16 logits, than twice the reference's own drift."""
    jcfg, tcfg, _, tb, pj, pt, tokens = _smoke_models(bf16=True,
                                                      layers=layers)
    j32 = jax_build_model(jcfg.replace(compute_dtype=jnp.float32))
    jb = jax_build_model(jcfg)
    feed_j, feed_t = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    lj32, _ = jax.jit(jax_prefill(j32))(pj, feed_j)
    lj, _ = jax.jit(jax_prefill(jb))(pj, feed_j)
    lt, _ = make_prefill_step(tb)(pt, feed_t)
    ref_drift = _rel_l2(torch.from_numpy(np.asarray(lj, np.float32)), lj32)
    port_drift = _rel_l2(lt, lj32)
    port_vs_ref = _rel_l2(lt, lj)
    print(f"bf16 vs f32 prefill logits, relative L2, {layers} smoke layers: "
          f"reference {ref_drift:.4f}, port {port_drift:.4f}, port vs "
          f"reference bf16 {port_vs_ref:.4f}")
    assert port_drift <= 2 * ref_drift
    assert port_vs_ref <= 2 * ref_drift


def test_serve_cli_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "mamba2-2.7b: generated 3 tokens/seq on cpu" in out
    assert out.count("  seq") == 2


def test_serve_cli_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="--device cpu|device='cpu'"):
        serve.main(["--smoke", "--prompt-len", "8", "--new-tokens", "1"])
