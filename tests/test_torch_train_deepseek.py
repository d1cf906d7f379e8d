"""Training of deepseek-v2 (MLA attention; the dense layer 0 and two MoE
layers of 4 experts, top 2, one shared expert) in the PyTorch port against
the JAX package, at the smoke config in f32 from bridged weights
(``tests/_torch_train.py``): ``loss_fn``'s loss, metrics and every
gradient leaf, one ``make_train_step`` step, and the three ``remat``
modes.

The reference runs op by op (``jax.disable_jit``): jitted, it flips a
near-tie expert choice at the smoke router (ROADMAP, Queue C). The loss
adds ``AUX_WEIGHT`` times the MoE layers' summed Switch aux loss over the
layers; on the CPU the dispatch runs through ``partition_pack``'s plain
version. The MoE layers run under ``remat``, the dense layer 0 does not,
as in the reference."""
import pytest

torch = pytest.importorskip("torch")

import _torch_train as TR  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


def test_loss_and_grads_match_reference():
    TR.check_loss_and_grads(ARCH)


def test_train_step_matches_reference():
    TR.check_train_step(ARCH)


def test_remat_modes_give_identical_gradients():
    TR.check_remat_modes(ARCH)
