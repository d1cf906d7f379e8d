"""Training of recurrentgemma (one (rec, rec, attn) triple and two
remainder recurrent layers, window 8) in the PyTorch port against the JAX
package, at the smoke config in f32 from bridged weights
(``tests/_torch_train.py``): ``loss_fn``'s loss, metrics and every
gradient leaf, one ``make_train_step`` step, and the three ``remat``
modes.

Its smoke config keeps ``grad_accum=2``, so the step sums two microbatches
of one row each (the divisible case of the reference's split). Each
triple runs under ``remat``; the remainder layers do not, as in the
reference."""
import pytest

torch = pytest.importorskip("torch")

import _torch_train as TR  # noqa: E402

ARCH = "recurrentgemma-9b"


def test_loss_and_grads_match_reference():
    TR.check_loss_and_grads(ARCH)


def test_train_step_matches_reference():
    TR.check_train_step(ARCH)


def test_remat_modes_give_identical_gradients():
    TR.check_remat_modes(ARCH)
