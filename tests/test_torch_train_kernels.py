"""How often a train step launches each kernel, worked out on the CPU.

On the card a train step runs every kernel of its forward through
``kernels/_autograd.py:kernel_call``: the forward launches the kernel, the
backward recomputes the plain version. Under ``remat`` every checkpointed
layer body runs its forward twice, once in the step and once when the
backward recomputes it, so a kernel in such a body launches twice a
microbatch; a kernel outside one (deepseek's dense layer 0) once. Here
each wrapper's launch is replaced by its plain version, counted where the
real one counts, and ``kernels.on_card`` answers True for CPU tensors,
so the models' entry points call the wrappers as they do on the card. A
step of every registered arch at its smoke config must then launch
exactly as ``launch/steps.py:train_launches`` works out (the counts that
chip_smoke.py checks on the card at full width), route no attention call
to the plain path, and give the gradients of the CPU's own path (whose
attention is the reference's algorithm, chunked, where the kernel's plain
version materializes the scores) to ``GRAD_TOL`` of each leaf's largest
entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ShapeConfig, registry  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402
from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.moe_combine import moe_combine as MK  # noqa
from repro_torch.kernels.moe_combine.ref import combine  # noqa: E402
from repro_torch.kernels.partition_pack import \
    partition_pack as PK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SK  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    grads_of, microbatches, train_launches)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.modules import init_params, tree_leaves  # noqa
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402

ARCHS = sorted(registry())
B, S = 2, 16
GRAD_TOL = 1e-4        # f32; two attention algorithms (TOL of the parity)


def _cfg(arch: str, remat: str):
    cfg = smoke_config(arch).replace(remat=remat)
    if cfg.attn_kind == "mla":
        # the smoke MLA heads (q/k 24, v 16) are no pair the kernel takes
        # (the card routes them to the plain path); q/k 16 = 8 + 8 is
        cfg = cfg.replace(qk_nope_head_dim=8, qk_rope_head_dim=8)
    return cfg


@pytest.fixture
def launched(monkeypatch):
    """-> (the launches by kernel, a function that takes the CUDA routing
    from then on)."""
    n = {"flash_gqa": 0, "ssd_scan": 0, "partition_pack": 0,
         "moe_combine": 0}

    def count(name, out):
        n[name] += 1
        return out

    def take_cuda_routing():
        monkeypatch.setattr(kernels, "on_card", lambda t: True)
        monkeypatch.setattr(FK, "_launch", lambda q, k, v, **kw: count(
            "flash_gqa", FK.plain(q, k, v, **kw)))
        monkeypatch.setattr(
            SK, "_launch", lambda x, dt, A, Bm, Cm, chunk: count(
                "ssd_scan", ssd_chunked(x, dt, A, Bm, Cm, chunk)))
        monkeypatch.setattr(
            PK, "_launch_pack_call", lambda g, ids, p, c, clocks: count(
                "partition_pack", PK.plain_pack(g, ids, p, c)))
        monkeypatch.setattr(MK, "_launch", lambda *t, C, S, k: count(
            "moe_combine", combine(*t, C, S, k)))
    return n, take_cuda_routing


def _grads(bundle, params, batch):
    """The gradients a train step takes, microbatch by microbatch."""
    out = []
    for mb in microbatches(batch, max(bundle.cfg.grad_accum, 1)):
        g, _ = grads_of(bundle.loss_fn, params, mb)
        out.append([t.numpy() for t in tree_leaves(g, torch.is_tensor)])
    return out


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_launches_each_kernel_as_worked_out(launched, arch,
                                                       remat):
    cfg = _cfg(arch, remat)
    bundle = build_model(cfg)
    params = init_params(bundle.param_defs,
                         torch.Generator().manual_seed(0), "cpu")
    batch = init_params(bundle.batch_defs(ShapeConfig("t", S, B, "train")),
                        None, "cpu")
    rng = np.random.default_rng(0)
    for k in ("tokens", "targets"):
        batch[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    plain = _grads(bundle, params, batch)
    counts, take_cuda_routing = launched
    take_cuda_routing()
    routed = FK.routed
    through = _grads(bundle, params, batch)
    want = train_launches(cfg)
    assert {k: counts[k] for k in want} == want
    assert FK.routed == routed
    for a, b in zip(through, plain, strict=True):
        for x, y in zip(a, b, strict=True):
            assert np.abs(x - y).max() <= GRAD_TOL * np.abs(y).max()
