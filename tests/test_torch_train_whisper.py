"""Training of whisper (2 encoder and 2 decoder layers, 12 frames, the
vocabulary padded from 512 to 51872) in the PyTorch port against the JAX
package, at the smoke config in f32 from bridged weights
(``tests/_torch_train.py``): ``loss_fn``'s loss, metrics and every
gradient leaf, one ``make_train_step`` step, and the three ``remat``
modes. The encoder runs in train mode, and every encoder and decoder
layer is recomputed whole under any ``remat`` but "none", as in the
reference."""
import pytest

torch = pytest.importorskip("torch")

import _torch_train as TR  # noqa: E402

ARCH = "whisper-tiny"


def test_loss_and_grads_match_reference():
    TR.check_loss_and_grads(ARCH)


def test_train_step_matches_reference():
    TR.check_train_step(ARCH)


def test_remat_modes_give_identical_gradients():
    TR.check_remat_modes(ARCH)
