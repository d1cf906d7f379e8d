"""Training of Mamba-2 in the PyTorch port against the JAX package, at the
smoke config in f32 from bridged weights (``tests/_torch_train.py``):
``loss_fn`` and its gradients, one ``make_train_step`` step, the three
``remat`` modes, and the chunked loss. The smoke configs set
``logit_chunk=0``, so the chunked loss runs here alone: ``logit_chunk=8``
over S = 32 (4 chunks, each recomputed in the backward), with mamba2's
vocabulary padded from 512 to 50288 and with smollm's tied, unpadded
head."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train as TR  # noqa: E402

ARCH = "mamba2-2.7b"
CHUNK, CHUNK_S = 8, 32
# chunked against whole: the same f32 terms, summed chunk by chunk
CHUNK_TOL = 1e-5


def test_loss_and_grads_match_reference():
    TR.check_loss_and_grads(ARCH)


def test_train_step_matches_reference():
    TR.check_train_step(ARCH)


def test_remat_modes_give_identical_gradients():
    TR.check_remat_modes(ARCH)


@pytest.mark.parametrize("arch", [ARCH, "smollm-135m"],
                         ids=["padded-vocab", "tied-unpadded"])
def test_chunked_loss_matches_reference_and_the_whole_loss(arch):
    got = TR.check_loss_and_grads(arch, s=CHUNK_S, logit_chunk=CHUNK)
    jcfg, tcfg = TR.cfgs(arch)
    jb, tb = TR.bundles(jcfg, tcfg)
    p, b = TR.params_np(jb, 3), TR.batch_np(jb, 4, s=CHUNK_S)
    if arch == ARCH:
        assert tcfg.pad_vocab_to > tcfg.vocab_size
    whole, wm = TR.port_grads(tb, p, b)
    chunked, cm = TR.port_grads(
        TR.build_model(tcfg.replace(logit_chunk=CHUNK)), p, b)
    np.testing.assert_allclose(float(cm["loss"]), float(wm["loss"]),
                               rtol=CHUNK_TOL)
    for a, w, c in zip(TR.leaves_port(got), TR.leaves_port(whole),
                       TR.leaves_port(chunked), strict=True):
        assert np.array_equal(a, c)
        assert np.abs(c - w).max() <= CHUNK_TOL * np.abs(w).max()
