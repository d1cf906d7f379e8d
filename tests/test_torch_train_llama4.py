"""Training of llama4 (one super-block of 4 sub-layers: chunked-local and
global attention, dense and MoE MLPs; 4 experts, top 1, one shared) in the
PyTorch port against the JAX package, at the smoke config in f32 from
bridged weights (``tests/_torch_train.py``): ``loss_fn``'s loss, metrics
and every gradient leaf, one ``make_train_step`` step, and the three
``remat`` modes.

The reference runs op by op (``jax.disable_jit``), as for deepseek.
llama4 is the one arch on Adafactor, and its smoke config keeps
``grad_accum=4`` at B = 2, so each of the 4 microbatches takes the whole
batch (the broadcast case of the reference's split). Each super-block
runs under ``remat``."""
import pytest

torch = pytest.importorskip("torch")

import _torch_train as TR  # noqa: E402

ARCH = "llama4-maverick-400b-a17b"


def test_loss_and_grads_match_reference():
    TR.check_loss_and_grads(ARCH)


def test_train_step_matches_reference():
    TR.check_train_step(ARCH)


def test_remat_modes_give_identical_gradients():
    TR.check_remat_modes(ARCH)
