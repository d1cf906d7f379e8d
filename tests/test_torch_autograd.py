"""The kernels inside autograd (``kernels/_autograd.py``): on the CPU,
each kernel wrapper's autograd Function, with its forward run in the plain
form (the launch replaced by the plain version), gives the gradients that
autograd through the plain version gives, exactly; integer outputs (ids,
counts, slots) get none; with grad off the launch is called directly. The
card tests hold the real launches' gradients against the CPU's
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_gqa import flash_gqa as FK  # noqa: E402
from repro_torch.kernels.partition_pack import \
    partition_pack as PK  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SK  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402
from repro_torch.relational.ops import partition_ids  # noqa: E402


def _leaves(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .requires_grad_() for s in shapes]


def _grads(outs, xs, cots):
    outs = [o for o in outs if o.is_floating_point()]
    return torch.autograd.grad(outs, xs, cots[:len(outs)])


def _same_grads(through, plain, xs, seed=0):
    """Gradients of ``through(*xs)`` (the wrapper) and ``plain(*xs)``
    under one random cotangent a float output."""
    got = through(*xs)
    rng = np.random.default_rng(seed)
    cots = [torch.from_numpy(rng.standard_normal(o.shape)
                             .astype(np.float32)).to(o.dtype)
            for o in got if o.is_floating_point()]
    assert all(o.grad_fn is not None and "Recompute" in o.grad_fn.name()
               for o in got if o.is_floating_point())
    g_got = _grads(got, xs, cots)
    fresh = [x.detach().clone().requires_grad_() for x in xs]
    g_want = _grads(plain(*fresh), fresh, cots)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("D,kv_head,window", [
    (64, None, 0), (32, (0, 0, 0, 1, 1, 1, 0, 0), 0), (64, None, 24)])
def test_flash_gqa_backward_is_the_plain_versions(monkeypatch, D, kv_head,
                                                  window):
    calls = []

    def launch(q, k, v, **kw):
        calls.append(1)
        return FK.plain(q, k, v, **kw)
    monkeypatch.setattr(FK, "_launch", launch)
    rng = np.random.default_rng(D)
    xs = _leaves(rng, (2, 48, 8, D), (2, 48, 2, D), (2, 48, 2, D))
    kw = dict(causal=True, window=window, kv_head=kv_head)
    _same_grads(lambda *t: (FK.flash_gqa(*t, **kw),),
                lambda *t: (FK.plain(*t, **kw),), xs)
    assert len(calls) == 1
    with torch.inference_mode():
        assert FK.flash_gqa(*xs, **kw).grad_fn is None
    assert len(calls) == 2


def test_ssd_scan_backward_is_the_plain_versions(monkeypatch):
    monkeypatch.setattr(
        SK, "_launch", lambda x, dt, A, Bm, Cm, chunk: ssd_chunked(
            x, dt, A, Bm, Cm, min(chunk, x.shape[1])))
    rng = np.random.default_rng(1)
    x, Bm, Cm = _leaves(rng, (2, 32, 4, 8), (2, 32, 2, 16), (2, 32, 2, 16))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((2, 32, 4)) - 1,
                                       0).astype(np.float32)).requires_grad_()
    A = torch.from_numpy(-np.exp(rng.standard_normal(4))
                         .astype(np.float32)).requires_grad_()
    y, state = _same_grads(lambda *t: SK.ssd_scan(*t, chunk=16),
                           lambda *t: ssd_chunked(*t, 16),
                           [x, dt, A, Bm, Cm])
    assert y.shape == x.shape and state.shape == (2, 4, 8, 16)


def test_pack_backward_is_the_plain_versions(monkeypatch):
    """A float group and an int group, ids out of range and a capacity
    below the largest count (rows dropped): only the float rows get a
    gradient, and a dropped row gets zero."""
    monkeypatch.setattr(PK, "_launch_pack_call",
                        lambda g, ids, n, cap, clocks: PK.plain_pack(
                            g, ids, n, cap))
    rng = np.random.default_rng(2)
    (rows,) = _leaves(rng, (300, 3))
    ints = torch.from_numpy(rng.integers(0, 99, (300, 2)))
    ids = torch.from_numpy(rng.integers(-1, 9, 300).astype(np.int32))

    def through(r):
        bufs, counts, slots = PK.pack([r, ints], ids, 8, 30)
        return (bufs[0], bufs[1], counts, slots)

    def plain(r):
        bufs, counts, slots = PK.plain_pack([r, ints], ids, 8, 30)
        return (bufs[0], bufs[1], counts, slots)

    buf, ibuf, counts, slots = _same_grads(through, plain, [rows])
    assert not ibuf.requires_grad and not counts.requires_grad
    assert int(counts.max()) > 30            # some rows were dropped
    (g,) = torch.autograd.grad(through(rows)[0].sum(), rows)
    dropped = (slots < 0) | (slots >= 30)
    assert torch.equal(g[dropped], torch.zeros_like(g[dropped]))
    assert torch.equal(g[~dropped], torch.ones_like(g[~dropped]))


def test_pack_by_key_backward_is_the_plain_versions(monkeypatch):
    def launch(groups, key, n):
        ids = partition_ids(key, n)
        cap = int(torch.bincount(ids, minlength=n).max())
        bufs, counts, _ = PK.plain_pack(groups, ids, n, cap)
        return bufs, counts.tolist(), ids
    monkeypatch.setattr(PK, "_launch_by_key", launch)
    rng = np.random.default_rng(3)
    (rows,) = _leaves(rng, (200, 4))
    key = torch.from_numpy(rng.integers(0, 1 << 40, 200))
    ids = partition_ids(key, 8)
    cap = int(torch.bincount(ids, minlength=8).max())
    got = {}

    def through(r):
        bufs, counts, out_ids = PK.pack_by_key([r], key, 8)
        got["counts"], got["ids"] = counts, out_ids
        return (bufs[0], out_ids)

    _same_grads(through, lambda r: (PK.plain_pack([r], ids, 8, cap)[0][0],
                                    ids), [rows])
    assert torch.equal(got["ids"], ids)
    assert got["counts"] == torch.bincount(ids, minlength=8).tolist()
