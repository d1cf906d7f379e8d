"""Smoke train-step FLOPs of the MoE, hybrid and audio families
(deepseek-v2-lite-16b, llama4, recurrentgemma-9b, whisper-tiny) in the
port's step analysis on the CPU against the JAX package's HLO count of
the compiled step, within ``FLOPS_TOL`` (the other six archs are in
``test_torch_dryrun.py``; a JAX compile a step makes them two files)."""
import pytest

pytest.importorskip("torch")

from test_torch_dryrun import FLOPS_TOL, HERE, smoke_train_flops  # noqa
from repro.configs.base import registry as jax_registry  # noqa: E402

ARCHS = [a for a in sorted(jax_registry()) if a not in HERE]


def test_the_two_files_cover_every_arch():
    assert len(ARCHS) == 4 and sorted(ARCHS + HERE) == sorted(jax_registry())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_flops_match_the_reference_hlo(arch):
    got, want = smoke_train_flops(arch)
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)
