"""The layouts the port states on a mesh where GSPMD would choose them
(``models/modules.py:Sharder``): FSDP weights gathered at use
(``Sharder.dot``, ``Sharder.einsum``), the vocabulary kept split through
the loss (``token_nll``) and the embedding lookup (``Sharder.lookup``),
and gradients returned in their parameters' layouts
(``launch/steps.grads_of``). On the fake 2x4 mesh the tests read the
collectives from the op record; the values are held against the
reference's functions on a real 2x2 mesh of four CPU processes (gloo)."""
import contextlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_mesh import B, LAYERS, S, meshes  # noqa: E402,F401
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.smoke import smoke_config  # noqa: E402

HERE = pathlib.Path(__file__).resolve()


def _dtensor(shape, mesh, placements, requires_grad=False):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch import kernels
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    t = kernels.from_local(torch.empty(local, device="meta"), mesh,
                           placements, shape)
    return t.requires_grad_(requires_grad)


def test_a_projection_gathers_its_weight_over_fsdp_only(meshes):  # noqa
    """x [B@data, S@model, d] @ w [d@data, n@model]: w is gathered over
    "data" and x over "model" (its sequence), the product is [B@data, S,
    n@model] whatever the release's per-operation strategy, and in the
    backward w's gradient is reduce-scattered over "data" into w's
    layout, x's over "model" into x's."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.step_analysis import analyze
    from repro_torch.models.modules import Sharder
    mesh = meshes["2x4"]
    x = _dtensor((4, 16, 64), mesh, [Shard(0), Shard(1)], True)
    w = _dtensor((64, 32), mesh, [Shard(0), Shard(1)], True)

    def step(x, w):
        y = Sharder(mesh, {}).dot(x, w)
        y.sum().backward()
        return y

    y, ana = analyze(step, x, w, record_ops=True)
    assert tuple(y.placements) == (Shard(0), Shard(2))
    assert tuple(x.grad.placements) == tuple(x.placements)
    assert tuple(w.grad.placements) == tuple(w.placements)
    colls = sorted((r["kind"], r["group"], tuple(r["shapes"][0]))
                   for r in ana["ops"] if "group" in r)
    assert ("all-gather", 2, (32, 8)) in colls           # w over data
    assert ("all-gather", 4, (2, 4, 64)) in colls        # x over model
    assert ("reduce-scatter", 2, (64, 8)) in colls       # dw over data
    assert not any(k == "all-gather" and g == 2 and len(s) == 3
                   for k, g, s in colls)                 # no batch gather


def test_the_loss_and_the_lookup_move_no_vocabulary(meshes):  # noqa: F811
    """mamba2-2.7b's smoke train step on 2x4 (its vocabulary padded to
    50288, split 4 ways): no collective moves an activation whose last dim
    is the vocabulary or its shard (logits [B, S, V]), since the loss
    reduces each device's max, sum of exponentials and label logit, and
    the lookup reduces its rows; the tied head's own gather and its
    gradient's reduce-scatter are 2-D."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.step_analysis import COLLECTIVES
    arch = "mamba2-2.7b"
    cfg = smoke_config(arch).replace(num_layers=LAYERS.get(arch, 2))
    ana, _ = lower_cell(arch, ShapeConfig("smoke", S, B, "train"),
                        meshes["2x4"], cfg=cfg, record_ops=True)
    vocab = {cfg.pad_vocab_to, cfg.pad_vocab_to // 4}
    moved = [r for r in ana["ops"] if r["kind"] in COLLECTIVES
             and any(len(s) > 2 and s[-1] in vocab for s in r["shapes"])]
    assert not moved, moved[:3]


def test_gradients_leave_in_their_parameters_layouts(meshes):  # noqa: F811
    """``grads_of`` on 2x4 for a smoke config of each family with a tied or
    vocab-split embedding: every gradient is laid out as its parameter,
    so the optimizer's redistribute moves nothing."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import Reshards, abstract_tree
    from repro_torch.launch.steps import grads_of
    from repro_torch.models.model import build_model
    from repro_torch.models.modules import tree_leaves
    from repro_torch.parallel.sharding import effective_rules
    for arch in ("mamba2-2.7b", "glm4-9b"):
        cfg = smoke_config(arch).replace(num_layers=2)
        rules = effective_rules(cfg)
        bundle = build_model(cfg, mesh=meshes["2x4"], rules=rules)
        params = abstract_tree(bundle.param_defs, meshes["2x4"], rules)
        batch = abstract_tree(bundle.batch_defs(ShapeConfig(
            "smoke", S, B, "train")), meshes["2x4"], rules)
        with implicit_replication(), Reshards():
            grads, _ = grads_of(bundle.loss_fn, params, batch)
        for p, g in zip(tree_leaves(params, torch.is_tensor),
                        tree_leaves(grads, torch.is_tensor)):
            assert tuple(g.placements) == tuple(p.placements), (arch, p.shape)


def test_a_weight_gathered_at_use_is_gathered_again_for_the_backward(
        meshes):  # noqa: F811
    """The head's product on 2x4 (x [4@data, 16@model, 64] @ w [64@data,
    512@model]) keeps the shard and gathers w again in the backward, as
    GSPMD's compiled step does, where inside a recomputed body (a layer
    under remat, whose recompute gathers it anyway) the gathered weight is
    saved: after the forward the live bytes differ by exactly the
    gathered local weight, and the backward issues one more all-gather of
    w's shard. On plain tensors the product is ``x @ w`` as before."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.step_analysis import StepAnalysis, analyze
    from repro_torch.models.modules import Sharder, recomputed
    mesh = meshes["2x4"]
    sh = Sharder(mesh, {})
    x = _dtensor((4, 16, 64), mesh, [Shard(0), Shard(1)], True)
    w = _dtensor((64, 512), mesh, [Shard(0), Shard(1)], True)
    live = []
    for ctx in (recomputed, contextlib.nullcontext):
        mode = StepAnalysis()
        mode.track(x)
        mode.track(w)
        with ctx(), mode:
            y = sh.dot(x, w)
            live.append(mode.live)
        del y
    gathered = 64 * 128 * 4                  # w's local shard gathered
    assert live[0] - live[1] == gathered

    def step(x, w):
        y = sh.dot(x, w)
        y.sum().backward()
        return y

    _, ana = analyze(step, x, w, record_ops=True)
    gathers = [r for r in ana["ops"] if r["kind"] == "all-gather"
               and r["shapes"][0] == [32, 128]]
    assert len(gathers) == 2                 # the forward's and again
    xp = torch.randn(4, 16, 64, requires_grad=True)
    wp = torch.randn(64, 512, requires_grad=True)
    y, want = Sharder().dot(xp, wp), xp @ wp
    assert torch.equal(y, want) and y.grad_fn.name() == want.grad_fn.name()
    g = torch.randn(4, 16, 512)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.autograd.grad(y, (xp, wp), g),
        torch.autograd.grad(want, (xp, wp), g)))


def test_a_microbatch_of_two_rows_keeps_the_stated_layout(
        meshes):  # noqa: F811
    """On 2x2x2 a microbatch of 2 rows (granite-20b's grad_accum 2 on a
    batch of 4) is laid out as the rules say, its rows over "pod" (the
    prefix of the batch axes that divides them), its sequence over
    "model", its embedding dim whole; a norm gathers its scale (split
    over the FSDP axes) at use and keeps that layout, where DTensor would
    split the embedding dim to match the scale. The next projection's
    products are those of the reference's compiled step (granite-20b's
    MLP gate): the forward gathers the weight and computes [16, 64] x
    [64, 48] a device, w's gradient [64, 16] x [16, 48], and x's gradient,
    a sum over the "model" split, [8, 48] x [48, 64]: its tokens split
    over the idle "data" axis, half the repeated count."""
    from repro_torch.launch.step_analysis import analyze
    from repro_torch.models.modules import Sharder, rms_norm
    from repro_torch.parallel.sharding import effective_rules
    mesh = meshes["2x2x2"]
    sh = Sharder(mesh, effective_rules(smoke_config("granite-20b")))
    lay = sh.placements((2, 16, 64), "batch", "seq", "act_embed")
    x = _dtensor((2, 16, 64), mesh, list(lay), True)
    scale = _dtensor((64,), mesh, list(sh.placements((64,), "embed")), True)
    w = _dtensor((64, 96), mesh, list(sh.placements((64, 96), "embed",
                                                     "mlp")), True)
    from torch.distributed.tensor import Replicate, Shard
    assert tuple(lay) == (Shard(0), Replicate(), Shard(1))

    def step(x, scale, w):
        h = rms_norm(x, scale)
        assert tuple(h.placements) == tuple(lay)
        y = sh.dot(h, w)
        y.sum().backward()
        return y

    y, ana = analyze(step, x, scale, w, record_ops=True)
    assert tuple(y.placements) == (Shard(0), Replicate(), Shard(2))
    assert tuple(scale.grad.placements) == tuple(scale.placements)
    assert ana["flops"] == (2 + 2 + 1) * 16 * 64 * 48


@pytest.mark.parametrize("split,mesh_name,rows,x_axes,w_axes,k,n", [
    # granite-20b's attention output on 2x2x2, 2 rows ("data" idle): the
    # sum over the "model" split of the heads moves over half the tokens
    ("tokens", "2x2x2", 2, ("batch", None, "act_heads"),
     ("heads_q", "embed"), 64, 64),
    # llama4's normed input on 2x4, 1 row ("data" idle): the weight keeps
    # its FSDP split of the contracted embedding dim
    ("contraction", "2x4", 1, ("batch", "seq", "act_embed"),
     ("embed", "mlp"), 64, 96)])
def test_a_product_on_an_idle_axis_does_half_the_repeated_work(
        meshes, split, mesh_name, rows, x_axes, w_axes, k, n):  # noqa: F811
    """Under grad, a projection of a microbatch whose rows leave a batch
    axis idle does half the FLOPs a device of the same product repeated
    on both of that axis' devices: split on the tokens where the result
    is a sum over a mesh axis of the idle one's size, or on the
    contraction where the weight's FSDP split covers it."""
    from repro_torch.launch.step_analysis import analyze
    from repro_torch.models.modules import Sharder
    from repro_torch.parallel.sharding import effective_rules
    mesh = meshes[mesh_name]
    sh = Sharder(mesh, effective_rules(smoke_config("granite-20b")))
    x = _dtensor((rows, 16, k), mesh,
                 list(sh.placements((rows, 16, k), *x_axes)), True)
    w = _dtensor((k, n), mesh, list(sh.placements((k, n), *w_axes)), True)

    def step(x, w):
        with torch.enable_grad():
            return sh.dot(x, w)

    y, ana = analyze(step, x, w)
    per_row = 1 if split == "tokens" else rows    # rows a device holds
    ways_n = 1 if split == "tokens" else mesh.size(mesh.ndim - 1)
    ways_k = mesh.size(mesh.ndim - 1) if split == "tokens" else 1
    repeated = 2 * per_row * 16 * (k // ways_k) * (n // ways_n)
    assert ana["flops"] == repeated / 2, (ana["flops"], repeated)
    assert y.shape == (rows, 16, n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# a real mesh's shape and axes for each case of the values test
_REAL_MESHES = {"batch": ((2, 2), ("data", "model")),
                "one_row": ((2, 2), ("data", "model")),
                "one_row_3d": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("case", list(_REAL_MESHES))
def test_on_a_real_mesh_the_values_are_the_reference_s(case):
    """CPU processes over gloo, one a device of a real mesh: 2x2 ("data",
    "model"), or 2x2x2 ("pod", "data", "model") for ``one_row_3d``. A
    batch of 4: the vocab-parallel loss and its gradient (logits split on
    both), the lookup of a vocab-split table and its gradient, and a
    projection and its gradients. A microbatch of one row (the batch axes
    idle), under grad: a projection whose tokens are split over an idle
    axis (its sum over the heads' "model" split) and one whose
    contraction is (the weight's FSDP split kept; over "pod" and "data"
    on 2x2x2, summed by one all-reduce), each with both gradients.
    Gathered whole, each equals the reference's functions
    (``_reference``, float64 numpy) on the same inputs to 1e-5; no JAX,
    so the test runs on the card's machine too."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parents[1] / "src"), str(HERE.parent)]))
    procs = [subprocess.Popen([sys.executable, str(HERE), str(r), str(port),
                               case],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(int(np.prod(_REAL_MESHES[case][0])))]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "values match" in outs[0], outs[0][-3000:]


def _reference(logits, labels, mask, table, ids, x, w, co) -> list:
    """The reference's functions in float64 numpy: the masked mean of
    logsumexp less the label logit (``softmax_cross_entropy``) and its
    gradient, ``table[ids]`` and the gradient of ``(table[ids] * x).sum()``,
    ``x @ w`` and the gradients of ``((x @ w) * co).sum()``."""
    lg = logits.astype(np.float64)
    m = lg.max(-1, keepdims=True)
    e = np.exp(lg - m)
    lse = np.log(e.sum(-1)) + m[..., 0]
    ll = np.take_along_axis(lg, labels[..., None].astype(np.int64), -1)[
        ..., 0]
    mf = mask.astype(np.float64)
    cnt = max(mf.sum(), 1.0)
    loss = ((lse - ll) * mf).sum() / cnt
    onehot = np.eye(lg.shape[-1])[labels]
    dlg = (e / e.sum(-1, keepdims=True) - onehot) * (mf / cnt)[..., None]
    dtable = np.zeros_like(table, dtype=np.float64)
    np.add.at(dtable, ids, x)
    return [loss, dlg, table[ids], dtable] + _reference_product(x, w, co)


def _reference_product(x, w, co) -> list:
    """``x @ w`` and the gradients of ``((x @ w) * co).sum()`` in float64
    numpy."""
    x, w, co = (a.astype(np.float64) for a in (x, w, co))
    return [x @ w, co @ w.T,
            x.reshape(-1, x.shape[-1]).T @ co.reshape(-1, co.shape[-1])]


def _worker(rank: int, port: int, case: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = _REAL_MESHES[case]
    n = int(np.prod(shape))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
    got, want = (_batch if case == "batch" else _one_row)(mesh)
    if rank == 0:
        for g, r in zip(got, want):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
        print("values match")
    dist.destroy_process_group()


def _one_row(mesh) -> tuple[list, list]:
    """A microbatch of one row, under grad, the batch axes idle: x [1, 6,
    8] @ w [8, 8] with x split on its heads over "model" and w on them
    and on its embedding dim (FSDP), the tokens split over the first
    batch axis; and x [1, 6, 8] @ w [8, 10] with x's sequence over
    "model" and w split over the batch axes on the contracted dim, which
    x takes. -> (each result and gradient gathered, the reference's)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.modules import Sharder
    sh = Sharder(mesh, {})
    rng = np.random.default_rng(1)
    got, want = [], []
    idle = [Replicate()] * (mesh.ndim - 1)
    for (xs, xpl), (ws, wpl), ypl in (
            (((1, 6, 8), idle + [Shard(2)]),
             ((8, 8), [Shard(1)] * (mesh.ndim - 1) + [Shard(0)]),
             (Shard(1),) + (Replicate(),) * (mesh.ndim - 1)),
            (((1, 6, 8), idle + [Shard(1)]),
             ((8, 10), [Shard(0)] * (mesh.ndim - 1) + [Shard(1)]),
             (Replicate(),) * (mesh.ndim - 1) + (Shard(2),))):
        x = rng.standard_normal(xs).astype(np.float32)
        w = rng.standard_normal(ws).astype(np.float32)
        co = rng.standard_normal(xs[:2] + ws[1:]).astype(np.float32)
        xd = distribute_tensor(torch.tensor(x), mesh, xpl).requires_grad_()
        wd = distribute_tensor(torch.tensor(w), mesh, wpl).requires_grad_()
        with torch.enable_grad():
            y = sh.dot(xd, wd)
            assert tuple(y.placements) == ypl, y.placements
            (y * distribute_tensor(torch.tensor(co), mesh, list(
                y.placements))).sum().backward()
        assert tuple(xd.grad.placements) == tuple(xpl)
        assert tuple(wd.grad.placements) == tuple(wpl)
        got += [t.full_tensor().detach().numpy() for t in (y, xd.grad,
                                                             wd.grad)]
        want += _reference_product(x, w, co)
    return got, want


def _batch(mesh) -> tuple[list, list]:
    """A batch of 4 rows: the loss, the lookup and a projection, with
    their gradients. -> (each gathered, the reference's)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models.modules import Sharder, softmax_cross_entropy
    sh = Sharder(mesh, {})
    rng = np.random.default_rng(0)
    b, s, v, d, n = 4, 6, 12, 8, 10
    logits = rng.standard_normal((b, s, v)).astype(np.float32) * 3
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.int32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, s)).astype(np.int32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, n)).astype(np.float32)
    co = rng.standard_normal((b, s, n)).astype(np.float32)

    def dt(a, placements, grad=False):
        return distribute_tensor(torch.tensor(a), mesh, placements
                                 ).requires_grad_(grad)

    lg = dt(logits, [Shard(0), Shard(2)], True)
    loss = softmax_cross_entropy(lg, dt(labels, [Shard(0), Shard(1)]),
                                 dt(mask, [Shard(0), Shard(1)]))
    loss.backward()
    tb = dt(table, [Shard(1), Shard(0)], True)
    emb = sh(sh.lookup(tb, dt(ids, [Shard(0), Shard(1)]), torch.float32),
             "batch", "seq", "act_embed")
    (emb * dt(x, list(emb.placements))).sum().backward()
    xd, wd = dt(x, [Shard(0), Shard(1)], True), dt(w, [Shard(0), Shard(1)],
                                                   True)
    y = sh.dot(xd, wd)
    (y * dt(co, list(y.placements))).sum().backward()
    got = [t.full_tensor().detach().numpy() for t in (
        loss, lg.grad, emb, tb.grad, y, xd.grad, wd.grad)]
    return got, _reference(logits, labels, mask, table, ids, x, w, co)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
